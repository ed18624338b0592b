"""Fast-diagonalization direct Poisson solver (linalg/fdm.py).

Checks the direct solve against the (verified) separable MG operator on
stretched, periodic, 2D and 3D grids, the float32 accuracy the accelerator
path relies on, and the end-to-end equivalence of the FDM-default pressure
solve with the round-3 CG+MG path (reference behavior being replaced:
navierstokes.cpp:566-580 with `-ksp_type cg -pc_type gamg`).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from petibm_jax.linalg.fdm import FastDiagPoisson, make_fdm_solver
from petibm_jax.linalg.mg import PoissonMG


def _stretched(n, r=1.03, h0=0.02):
    return h0 * r ** np.arange(n)


def _check_direct(dxp, periodic, scale=0.01, dtype=jnp.float64, tol=1e-10):
    rng = np.random.default_rng(7)
    mg = PoissonMG(dxp, periodic, dtype=dtype, scale=scale)
    fdm = FastDiagPoisson(dxp, periodic, dtype=dtype, scale=scale)
    shape = mg.levels[0].shape
    b = rng.standard_normal(shape)
    b -= b.mean()  # consistent RHS (range of the all-Neumann operator)
    b = jnp.asarray(b, dtype)
    x = fdm.solve(b)
    r = b - mg.apply_op(0, x)
    rel = float(jnp.linalg.norm(r) / jnp.linalg.norm(b))
    assert rel < tol, rel
    return fdm, mg


def test_direct_solve_2d_stretched():
    _check_direct([_stretched(37), _stretched(29, 1.05)], [False, False])


def test_direct_solve_periodic():
    # periodic-x / wall-y, uniform-periodic direction (TGV-style grids)
    _check_direct([np.full(32, 0.05), _stretched(21)], [True, False])
    _check_direct([np.full(16, 0.1), np.full(24, 0.07)], [True, True])


def test_direct_solve_3d():
    _check_direct([_stretched(13), _stretched(11, 1.04), np.full(9, 0.1)],
                  [False, False, True])


def test_fft_path_matches_eigh():
    """Periodic uniform axes take the rfft/irfft circulant path; it must
    agree with the dense-eigh transforms (f32: to rounding; the existing
    periodic tests above already pin the FFT path against the MG operator
    at 1e-10 in f64)."""
    cases = [
        ([np.full(32, 0.05), np.full(48, 0.03)], [True, True], 2),
        ([np.full(32, 0.05), _stretched(21)], [True, False], 1),
        ([np.full(12, 0.1), np.full(16, 0.05), _stretched(9)],
         [True, True, False], 2),
    ]
    rng = np.random.default_rng(5)
    for dxp, periodic, n_fft in cases:
        a = FastDiagPoisson(dxp, periodic, dtype=jnp.float32, scale=0.01)
        b = FastDiagPoisson(dxp, periodic, dtype=jnp.float32, scale=0.01,
                            use_fft=False)
        assert len(a._fft_axes) == n_fft and not b._fft_axes
        shape = tuple(reversed([len(d) for d in dxp]))
        r = rng.standard_normal(shape).astype(np.float32)
        xa = np.asarray(a.solve(jnp.asarray(r)))
        xb = np.asarray(b.solve(jnp.asarray(r)))
        scale = max(1.0, float(np.abs(xb).max()))
        np.testing.assert_allclose(xa, xb, atol=3e-5 * scale)


def test_fft_path_skips_stretched_periodic():
    """A periodic but STRETCHED axis is tridiagonal-circulant only in the
    wraparound sense, not circulant — it must keep the dense transforms."""
    fdm = FastDiagPoisson([_stretched(16), np.full(12, 0.1)],
                          [True, True], dtype=jnp.float64, scale=0.5)
    assert fdm._fft_axes == (0,)  # only uniform direction y (array axis 0)


def test_fft_helmholtz_matches_eigh():
    from petibm_jax.linalg.fdm import FastDiagHelmholtz

    n, h = 24, 0.04
    dl = _stretched(17)
    mid = 0.5 * (dl[:-1] + dl[1:])  # W-symmetry needs dneg[i+1] = dpos[i]
    lines = [
        {"dl": np.full(n, h), "dneg": np.full(n, h), "dpos": np.full(n, h),
         "a0": None, "periodic": True},
        {"dl": dl, "dneg": np.concatenate([[0.6 * dl[0]], mid]),
         "dpos": np.concatenate([mid, [0.6 * dl[-1]]]),
         "a0": (1.0, -1.0), "periodic": False},
    ]
    a = FastDiagHelmholtz(lines, dt=0.01, cnu=0.02, dtype=jnp.float64)
    b = FastDiagHelmholtz(lines, dt=0.01, cnu=0.02, dtype=jnp.float64,
                          use_fft=False)
    assert a._fft_axes == (1,) and not b._fft_axes
    rng = np.random.default_rng(9)
    r = jnp.asarray(rng.standard_normal((17, n)))
    np.testing.assert_allclose(np.asarray(a.solve(r)),
                               np.asarray(b.solve(r)), atol=1e-11)


def test_float32_accuracy():
    """f32: the direct pass lands ~1e-5 relative (set by the operator's
    conditioning at f32 rounding) and ONE refinement pass reaches the
    1e-8 range — the production path's convergence contract."""
    dxp = [_stretched(96, 1.02), _stretched(96, 1.02)]
    fdm, mg = _check_direct(dxp, [False, False], dtype=jnp.float32,
                            tol=1e-4)
    from petibm_jax.linalg.krylov import cg

    rng = np.random.default_rng(7)
    b = rng.standard_normal(mg.levels[0].shape)
    b -= b.mean()
    b = jnp.asarray(b, jnp.float32)
    bnorm = float(jnp.linalg.norm(b))

    def M(r):
        out = fdm.solve(r)
        return out - jnp.mean(out)

    res = cg(lambda p: mg.apply_op(0, p), b, jnp.zeros_like(b), M=M,
             atol=1e-6 * bnorm, maxiter=10)
    assert bool(res.converged)
    assert int(res.iters) <= 3, int(res.iters)


def test_nullspace_component_discarded():
    """b with a constant (nullspace) component: the solve ignores it and
    returns the minimum-norm solution of the consistent part."""
    dxp = [_stretched(17), _stretched(19)]
    mg = PoissonMG(dxp, [False, False], dtype=jnp.float64, scale=0.5)
    fdm = FastDiagPoisson(dxp, [False, False], dtype=jnp.float64, scale=0.5)
    rng = np.random.default_rng(3)
    b0 = rng.standard_normal(mg.levels[0].shape)
    b0 -= b0.mean()
    x0 = fdm.solve(jnp.asarray(b0))
    x1 = fdm.solve(jnp.asarray(b0 + 5.0))  # add a nullspace component
    np.testing.assert_allclose(np.asarray(x0), np.asarray(x1), atol=1e-9)
    # A x recovers the consistent part only
    r = jnp.asarray(b0) - mg.apply_op(0, x0)
    assert float(jnp.linalg.norm(r)) < 1e-9 * float(jnp.linalg.norm(x0) + 1)


def test_refinement_solver_semantics():
    dxp = [_stretched(25), _stretched(31)]
    mg = PoissonMG(dxp, [False, False], dtype=jnp.float64, scale=0.01)
    fdm = FastDiagPoisson(dxp, [False, False], dtype=jnp.float64, scale=0.01)
    solve = make_fdm_solver(fdm, lambda p: mg.apply_op(0, p),
                            {"atol": 1e-12, "rtol": 0.0, "max_it": 50})
    rng = np.random.default_rng(11)
    b = rng.standard_normal(mg.levels[0].shape)
    b -= b.mean()
    b = jnp.asarray(b)
    res = solve(b, jnp.zeros_like(b))
    assert bool(res.converged)
    assert float(res.residual) <= 1e-12
    assert int(res.iters) <= 2  # direct solve + at most refinement touch-ups


@pytest.mark.parametrize("disable", [False, True])
def test_cavity_fdm_matches_mgcg(tmp_path, disable):
    """End-to-end: the FDM-default pressure solve reproduces the CG+MG
    solution of the same cavity flow (both converged to atol 1e-9)."""
    from petibm_jax.solvers.navierstokes import NavierStokesSolver

    def config(fdm_enabled):
        out = tmp_path / ("fdm" if fdm_enabled else "mg")
        return {
            "directory": str(tmp_path), "output": str(out),
            "logs": str(out / "logs"),
            "mesh": [
                {"direction": "x", "start": 0.0,
                 "subDomains": [{"end": 1.0, "cells": 24, "stretchRatio": 1.0}]},
                {"direction": "y", "start": 0.0,
                 "subDomains": [{"end": 1.0, "cells": 24, "stretchRatio": 1.0}]},
            ],
            "flow": {
                "nu": 0.01, "initialVelocity": [0.0, 0.0],
                "boundaryConditions": [
                    {"location": "xMinus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
                    {"location": "xPlus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
                    {"location": "yMinus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
                    {"location": "yPlus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
                ],
            },
            "parameters": {
                "dt": 0.01, "nt": 5, "nsave": 100, "nrestart": 100,
                "fdm": fdm_enabled,
                "poissonSolver": {"type": "CPU", "atol": 1e-9, "rtol": 0.0},
                "velocitySolver": {"type": "CPU", "atol": 1e-9, "rtol": 0.0},
            },
        }

    sol = NavierStokesSolver(config(not disable))
    if disable:
        assert getattr(sol, "poisson_fdm", None) is None
    else:
        assert sol.poisson_fdm is not None
    for _ in range(5):
        sol.advance()
    sol.close()
    if disable:
        test_cavity_fdm_matches_mgcg._mg = np.asarray(sol.state["p"])
    else:
        test_cavity_fdm_matches_mgcg._fdm = np.asarray(sol.state["p"])
    fdm = getattr(test_cavity_fdm_matches_mgcg, "_fdm", None)
    mgp = getattr(test_cavity_fdm_matches_mgcg, "_mg", None)
    if fdm is not None and mgp is not None:
        np.testing.assert_allclose(fdm - fdm.mean(), mgp - mgp.mean(),
                                   atol=1e-7)


def test_helmholtz_direct_solve_matches_operator(tmp_path):
    """FastDiagHelmholtz inverts the BC-folded implicit momentum operator
    to rounding, per component, on a stretched cavity grid (Dirichlet
    walls) and a channel with a convective outlet."""
    from petibm_jax.boundary import BoundarySet
    from petibm_jax.linalg.fdm import FastDiagHelmholtz, helmholtz_lines
    from petibm_jax.mesh import StaggeredMesh
    from petibm_jax.operators import make_laplacian
    from petibm_jax.types import Field

    cfg = {
        "mesh": [
            {"direction": "x", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": 18, "stretchRatio": 1.06}]},
            {"direction": "y", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": 14, "stretchRatio": 1.0}]},
        ],
        "flow": {"nu": 0.02, "initialVelocity": [1.0, 0.0],
                 "boundaryConditions": [
                     {"location": "xMinus", "u": ["DIRICHLET", 1.0],
                      "v": ["DIRICHLET", 0.0]},
                     {"location": "xPlus", "u": ["CONVECTIVE", 1.0],
                      "v": ["CONVECTIVE", 1.0]},
                     {"location": "yMinus", "u": ["DIRICHLET", 0.0],
                      "v": ["DIRICHLET", 0.0]},
                     {"location": "yPlus", "u": ["NEUMANN", 0.0],
                      "v": ["DIRICHLET", 0.0]}]},
    }
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    lap = make_laplacian(mesh, bcs, jnp.float64)
    dt, cnu = 0.01, 0.5 * 0.02
    rng = np.random.default_rng(9)
    for c, name in enumerate(("u", "v")):
        helm = FastDiagHelmholtz(helmholtz_lines(mesh, bcs, c), dt, cnu,
                                 dtype=jnp.float64)
        b = jnp.asarray(rng.standard_normal(mesh.shape(Field(c))))
        x = helm.solve(b)
        q = {"u": jnp.zeros(mesh.shape(Field.U), jnp.float64),
             "v": jnp.zeros(mesh.shape(Field.V), jnp.float64)}
        q[name] = x
        ax = lap(q, None, homogeneous=True)[name]
        r = b - (x / dt - cnu * ax)
        rel = float(jnp.linalg.norm(r) / jnp.linalg.norm(b))
        assert rel < 1e-12, (name, rel)


def test_velocity_fdm_preconditioner_iterations(tmp_path):
    """With the Helmholtz FDM preconditioner the momentum CG converges in
    ~1 iteration; physics matches the Jacobi run."""
    from petibm_jax.solvers.navierstokes import NavierStokesSolver

    def cfg(out, vfdm):
        return {
            "directory": str(tmp_path), "output": str(out),
            "logs": str(out / "logs"),
            "mesh": [
                {"direction": "x", "start": 0.0,
                 "subDomains": [{"end": 1.0, "cells": 24, "stretchRatio": 1.0}]},
                {"direction": "y", "start": 0.0,
                 "subDomains": [{"end": 1.0, "cells": 24, "stretchRatio": 1.0}]},
            ],
            "flow": {"nu": 0.01, "initialVelocity": [0.0, 0.0],
                     "boundaryConditions": [
                         {"location": loc, "u": ["DIRICHLET", 1.0 if loc == "yPlus" else 0.0],
                          "v": ["DIRICHLET", 0.0]}
                         for loc in ("xMinus", "xPlus", "yMinus", "yPlus")]},
            "parameters": {
                "dt": 0.01, "nt": 5, "nsave": 100, "nrestart": 100,
                "fdm": {"velocity": vfdm},
                "velocitySolver": {"type": "CPU", "atol": 1e-10,
                                   "rtol": 0.0},
                "poissonSolver": {"type": "CPU", "atol": 1e-10,
                                  "rtol": 0.0},
            },
        }

    import jax

    sa = NavierStokesSolver(cfg(tmp_path / "a", True))
    sb = NavierStokesSolver(cfg(tmp_path / "b", False))
    for _ in range(5):
        sa.state, stats_a = sa._step_fn(sa.state)
        sb.state, stats_b = sb._step_fn(sb.state)
    stats_a, stats_b = jax.device_get((stats_a, stats_b))
    # direct + refinement: 0-1 refinement passes
    assert int(stats_a["v_iters"]) <= 1, int(stats_a["v_iters"])
    assert bool(stats_a["v_ok"]) and bool(stats_b["v_ok"])
    np.testing.assert_allclose(np.asarray(sa.state["q"]["u"]),
                               np.asarray(sb.state["q"]["u"]), atol=1e-9)
    sa.close(), sb.close()


def test_refinement_stagnation_reports_nonconvergence():
    """A deliberately bad approximate inverse makes the refinement stall;
    the solver must exit via the stagnation guard with converged=False
    (feeding the divergence: abort policy) instead of looping to max_it."""
    import jax.numpy as jnp

    class BadM:
        @staticmethod
        def solve(r):
            return 1e-3 * r  # hopeless "inverse": residual barely moves

    A = lambda x: 2.0 * x  # trivial SPD operator
    solve = make_fdm_solver(BadM, A, {"atol": 1e-12, "rtol": 0.0,
                                      "max_it": 500})
    b = jnp.ones((8, 8))
    res = solve(b, jnp.zeros_like(b))
    assert not bool(res.converged)
    assert int(res.iters) < 500  # stagnation guard, not max_it grind
