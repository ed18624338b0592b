"""PCR tridiagonal solver: exactness vs direct solutions, agreement of
the MG line sweep with lax.linalg.tridiagonal_solve, and MG convergence
with the PCR smoother path forced on."""

import jax.numpy as jnp
import numpy as np
import pytest

from petibm_jax.linalg.tridiag import tridiag_solve_pcr


def _random_system(rng, batch, n):
    a = -rng.random(batch + (n,)) * 0.4
    c = -rng.random(batch + (n,)) * 0.4
    b = 1.0 + np.abs(a) + np.abs(c)  # strictly diagonally dominant
    x = rng.standard_normal(batch + (n,))
    d = b * x
    if n > 1:
        d[..., 1:] += a[..., 1:] * x[..., :-1]
        d[..., :-1] += c[..., :-1] * x[..., 1:]
    return a, b, c, d, x


def test_pcr_matches_direct_solutions():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 7, 16, 100, 450):
        a, b, c, d, x = _random_system(rng, (4, 5), n)
        got = tridiag_solve_pcr(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(c), jnp.asarray(d))
        np.testing.assert_allclose(np.asarray(got), x, rtol=0, atol=1e-10)


def test_pcr_poisson_line_systems():
    """The smoother's actual systems: FV Poisson line matrices on a
    stretched grid (variable coefficients, large ratios)."""
    rng = np.random.default_rng(1)
    w = np.geomspace(1.0, 40.0, 128)  # strongly stretched widths
    inv = 1.0 / (0.5 * (w[:-1] + w[1:]))
    a = np.zeros(128)
    c = np.zeros(128)
    a[1:] = -inv
    c[:-1] = -inv
    b = -(a + c) + 1e-3  # shifted singular line matrix -> SPD
    x = rng.standard_normal((6, 128))
    d = b * x
    d[..., 1:] += a[1:] * x[..., :-1]
    d[..., :-1] += c[:-1] * x[..., 1:]
    got = tridiag_solve_pcr(*(jnp.asarray(np.broadcast_to(v, x.shape).copy())
                              for v in (a, b, c)), jnp.asarray(d))
    np.testing.assert_allclose(np.asarray(got), x, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("dim,periodic", [
    (2, (False, False)), (2, (True, False)),
    (3, (False, False, False)), (3, (False, True, True)),
], ids=["2d-walls", "2d-xperiodic", "3d-walls", "3d-yzperiodic"])
def test_line_sweep_pcr_matches_lax(dim, periodic):
    """One MG smoothing pass (every direction's line sweep) on a stretched
    grid gives the same result with the jnp PCR as with
    lax.linalg.tridiagonal_solve, the default backend."""
    from petibm_jax.linalg.mg import PoissonMG

    rng = np.random.default_rng(6)
    ns = (12, 9, 7)[:dim]
    widths = [np.geomspace(1.0, 2.5, n) / n for n in ns]
    mg = PoissonMG(widths, list(periodic), dtype=jnp.float64)
    shape = tuple(reversed(ns))
    phi = jnp.asarray(rng.standard_normal(shape))
    rhs = jnp.asarray(rng.standard_normal(shape))
    assert not mg.use_pcr  # tridiagonal_solve by default
    ref = mg.smooth(0, phi, rhs, 2)
    mg.use_pcr = True
    got = mg.smooth(0, phi, rhs, 2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


def test_mgcg_with_pcr_smoother():
    """Force the PCR path on a stretched 2D mesh: MG-preconditioned CG
    must converge as well as with the default tridiagonal_solve."""
    from petibm_jax.linalg.krylov import cg
    from petibm_jax.linalg.mg import PoissonMG

    rng = np.random.default_rng(2)
    widths = [np.geomspace(1.0, 3.0, 48), np.geomspace(1.0, 2.0, 40)]
    mg = PoissonMG(widths, [False, False], dtype=jnp.float64)
    assert not mg.use_pcr  # tridiagonal_solve by default
    mg.use_pcr = True
    rhs = rng.standard_normal((40, 48))
    rhs -= rhs.mean()
    rhs = jnp.asarray(rhs)
    sol = cg(lambda p: mg.apply_op(0, p), rhs, jnp.zeros_like(rhs),
             M=mg.preconditioner(), atol=1e-10, maxiter=60)
    assert bool(sol.converged)
    assert int(sol.iters) < 30


def test_short_lines_avoid_tridiagonal_solve(monkeypatch):
    """cuSPARSE's batched tridiagonal solver refuses lines shorter than 3
    points, which the coarsest MG levels have: those lines go to PCR."""
    import jax.lax.linalg as lax_linalg

    from petibm_jax.linalg.mg import PoissonMG

    orig = lax_linalg.tridiagonal_solve
    seen = []

    def checked(dl, d, du, b):
        seen.append(d.shape[-1])
        assert d.shape[-1] >= 3, d.shape
        return orig(dl, d, du, b)

    monkeypatch.setattr(lax_linalg, "tridiagonal_solve", checked)
    widths = [np.geomspace(1.0, 2.0, 16), np.geomspace(1.0, 1.5, 8)]
    mg = PoissonMG(widths, [False, False], dtype=jnp.float64)
    assert min(mg.levels[-1].shape) < 3
    rhs = np.random.default_rng(7).standard_normal((8, 16))
    out = mg.vcycle(0, jnp.asarray(rhs - rhs.mean()))
    assert np.all(np.isfinite(np.asarray(out)))
    assert seen and min(seen) >= 3
