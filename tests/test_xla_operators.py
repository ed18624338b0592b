"""The solver's XLA stencil operators against independent references: the
negated pressure operator -D B1 G against a finite-volume matrix assembled
cell by cell in scipy.sparse, the 3D implicit momentum operator against
its assembled Helmholtz matrix, and the 3D convection closure against a
NumPy loop over grid points."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from petibm_jax.linalg.fdm import helmholtz_lines
from petibm_jax.solvers.navierstokes import NavierStokesSolver
from petibm_jax.types import Field

DT = 0.05
NU = 0.01


def box_solver(tmp_path, ns, periodic, poisson_type="CPU"):
    """A NavierStokesSolver on a box with ``ns`` cells per direction (x, y
    [, z]); periodic directions wrap, the first wall direction is
    stretched, walls are Dirichlet except a convective x+ outlet."""
    names, comps = "xyz"[:len(ns)], "uvw"[:len(ns)]
    first_wall = next((d for d in range(len(ns)) if not periodic[d]), None)
    mesh = [{"direction": names[d], "start": 0.0,
             "subDomains": [{"end": 1.0 + 0.3 * d, "cells": ns[d],
                             "stretchRatio": 1.1 if d == first_wall
                             else 1.0}]}
            for d in range(len(ns))]
    bcs = []
    for d in range(len(ns)):
        for side in ("Minus", "Plus"):
            if periodic[d]:
                node = {c: ["PERIODIC", 0.0] for c in comps}
            elif d == 0 and side == "Plus":
                node = {c: ["CONVECTIVE", 1.0] for c in comps}
            else:
                node = {c: ["DIRICHLET", 0.3 if c == "u" else 0.0]
                        for c in comps}
            bcs.append({"location": names[d] + side, **node})
    cfg = {
        "mesh": mesh,
        "flow": {"nu": NU, "initialVelocity": [0.3] + [0.0] * (len(ns) - 1),
                 "boundaryConditions": bcs},
        "parameters": {
            "dt": DT, "nt": 1, "nsave": 0, "nrestart": 0,
            "convection": "ADAMS_BASHFORTH_2",
            "diffusion": "CRANK_NICOLSON",
            "velocitySolver": {"type": "CPU"},
            "poissonSolver": {"type": poisson_type}},
        "directory": str(tmp_path), "output": str(tmp_path / "out"),
        "logs": str(tmp_path / "out"),
    }
    return NavierStokesSolver(cfg)


def fv_poisson_matrix(dxp, periodic, dt):
    """-D B1 G assembled face by face: the face between neighbouring cells
    a, b in direction d has coefficient dt * (the cell's widths in the
    other directions) / (0.5 * (w_a + w_b)); walls carry no flux, periodic
    directions wrap.  Rows and columns in (z, y, x) C order."""
    dim = len(dxp)
    ns = [len(w) for w in dxp]
    shape = tuple(reversed(ns))
    rows, cols, vals = [], [], []
    for idx in np.ndindex(*shape):
        ijk = idx[::-1]
        row = np.ravel_multi_index(idx, shape)
        for d in range(dim):
            area = math.prod(dxp[e][ijk[e]] for e in range(dim) if e != d)
            for step in (-1, 1):
                nb = list(ijk)
                nb[d] += step
                if not 0 <= nb[d] < ns[d]:
                    if not periodic[d]:
                        continue
                    nb[d] %= ns[d]
                c = dt * area / (0.5 * (dxp[d][ijk[d]] + dxp[d][nb[d]]))
                rows += [row, row]
                cols += [row, np.ravel_multi_index(tuple(nb[::-1]), shape)]
                vals += [c, -c]
    n = math.prod(ns)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


@pytest.mark.parametrize("ns,periodic,pinned", [
    ((9, 7), (False, False), False),
    ((8, 7), (True, False), False),
    ((6, 5, 4), (False, False, False), False),
    ((6, 5, 4), (True, False, True), False),
    ((9, 7), (False, False), True),
], ids=["2d-walls", "2d-xperiodic", "3d-walls", "3d-xzperiodic",
        "2d-pinned"])
def test_negA_p_matches_assembled_fv_matrix(tmp_path, ns, periodic, pinned):
    s = box_solver(tmp_path, ns, periodic,
                   poisson_type="GPU" if pinned else "CPU")
    assert s.is_ref_p == pinned
    A = fv_poisson_matrix([np.asarray(w) for w in s.mesh.dxp], periodic, DT)
    if pinned:
        # AmgX-style pinned dof (navierstokes.cpp:414-420): column 0 drops
        # out, row 0 returns the negated pinned value
        A = A.tolil()
        A[:, 0] = 0.0
        A[0, :] = 0.0
        A[0, 0] = -1.0
        A = A.tocsr()
    rng = np.random.default_rng(0)
    phi = rng.standard_normal(s.mesh.shape(Field.P))
    got = np.asarray(s._negA_p(jnp.asarray(phi))).ravel()
    np.testing.assert_allclose(got, A @ phi.ravel(), rtol=1e-12, atol=1e-12)


def helmholtz_matrix(lines, dt, cnu):
    """I/dt - cnu * L for one velocity component, L the Kronecker sum of
    its 1D folded Laplacians (ghost = a0 * boundary-adjacent value at
    walls, wraparound where periodic), assembled in scipy.sparse."""
    dim = len(lines)
    eyes = [sp.identity(len(ln["dl"]), format="csr") for ln in lines]
    L = None
    for d, ln in enumerate(lines):
        dl, dneg, dpos = (np.asarray(ln[k], np.float64)
                          for k in ("dl", "dneg", "dpos"))
        n = len(dl)
        cn, cp = 1.0 / (dneg * dl), 1.0 / (dpos * dl)
        T = sp.lil_matrix((n, n))
        for i in range(n):
            T[i, i] -= cn[i] + cp[i]
            for j, c in ((i - 1, cn[i]), (i + 1, cp[i])):
                if 0 <= j < n:
                    T[i, j] += c
                elif ln["periodic"]:
                    T[i, j % n] += c
                else:  # ghost folded onto the boundary-adjacent point
                    T[i, i] += c * ln["a0"][0 if j < 0 else 1]
        # array axes run (z, y, x): direction d is axis dim-1-d
        factors = [eyes[dim - 1 - ax] for ax in range(dim)]
        factors[dim - 1 - d] = T.tocsr()
        term = factors[0]
        for f in factors[1:]:
            term = sp.kron(term, f, format="csr")
        L = term if L is None else L + term
    return sp.identity(L.shape[0]) / dt - cnu * L


@pytest.mark.parametrize("periodic", [(False, False, False),
                                      (False, True, True)],
                         ids=["walls", "yzperiodic"])
def test_momentum_3d_matches_assembled_helmholtz(tmp_path, periodic):
    s = box_solver(tmp_path, (6, 5, 4), periodic)
    cnu = s.diff_ti.implicit_coeff * s.nu
    rng = np.random.default_rng(1)
    q = {name: rng.standard_normal(s.mesh.shape(Field(c)))
         for c, name in enumerate("uvw")}
    got = s.A_momentum({k: jnp.asarray(v) for k, v in q.items()})
    for c, name in enumerate("uvw"):
        A = helmholtz_matrix(helmholtz_lines(s.mesh, s.bc, c), DT, cnu)
        np.testing.assert_allclose(np.asarray(got[name]).ravel(),
                                   A @ q[name].ravel(), rtol=1e-12,
                                   atol=1e-10, err_msg=name)


def convection_reference(q, widths, periodic):
    """N_c = sum_d (adv+ * avg+ - adv- * avg-) / dl_c,d point by point
    (createconvection.cpp:40-195): avg are 2-point averages of component
    c along d, adv the 2-point average of component d across c.  Points
    whose stencil leaves a non-periodic array are skipped (None)."""
    dim = len(q)
    names = "uvw"[:dim]

    def at(arr, idx):
        out = []
        for ax, i in enumerate(idx):
            n = arr.shape[ax]
            if not 0 <= i < n:
                if not periodic[dim - 1 - ax]:
                    return None
                i %= n
            out.append(i)
        return arr[tuple(out)]

    def shift(idx, d, k):
        idx = list(idx)
        idx[dim - 1 - d] += k
        return tuple(idx)

    out = {}
    for c in range(dim):
        uc = q[names[c]]
        res = np.full(uc.shape, np.nan)
        for p in np.ndindex(*uc.shape):
            total = 0.0
            for d in range(dim):
                ud = q[names[d]]
                vals = [at(uc, shift(p, d, -1)), at(uc, p),
                        at(uc, shift(p, d, 1)),
                        at(ud, shift(p, d, -1)),
                        at(ud, shift(shift(p, d, -1), c, 1)),
                        at(ud, p), at(ud, shift(p, c, 1))]
                if any(v is None for v in vals):
                    total = None
                    break
                cm, c0, cp, dm0, dm1, dp0, dp1 = vals
                avg_m, avg_p = 0.5 * (cm + c0), 0.5 * (c0 + cp)
                if d == c:
                    term = avg_p * avg_p - avg_m * avg_m
                else:
                    term = (0.5 * (dp0 + dp1) * avg_p
                            - 0.5 * (dm0 + dm1) * avg_m)
                total += term / widths[c][d][p[dim - 1 - d]]
            if total is not None:
                res[p] = total
        out[names[c]] = res
    return out


@pytest.mark.parametrize("periodic", [(True, True, True),
                                      (False, True, False)],
                         ids=["periodic", "walls-interior"])
def test_convection_3d_matches_loop_reference(tmp_path, periodic):
    s = box_solver(tmp_path, (6, 5, 4), periodic)
    rng = np.random.default_rng(2)
    q = {name: rng.standard_normal(s.mesh.shape(Field(c)))
         for c, name in enumerate("uvw")}
    qj = {k: jnp.asarray(v) for k, v in q.items()}
    got = s.convect(qj, s.bc.init_state(qj, jnp.float64))
    widths = [[np.asarray(s.mesh.dl(Field(c), d)) for d in range(3)]
              for c in range(3)]
    ref = convection_reference(q, widths, periodic)
    for name in "uvw":
        mask = ~np.isnan(ref[name])
        assert mask.sum() >= 6, name
        np.testing.assert_allclose(np.asarray(got[name])[mask],
                                   ref[name][mask], rtol=1e-12, atol=1e-12,
                                   err_msg=name)
