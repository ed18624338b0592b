"""Physics validation: Taylor-Green analytic decay (2D periodic + symbolic
ICs) and a 3D end-to-end solver run (reference validation strategy:
SURVEY.md §4, examples/navierstokes/taylorgreenvortex2dRe100)."""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest

from petibm_jax.solvers.navierstokes import NavierStokesSolver
from petibm_jax.types import Field

PI = 3.141592653589793


def tgv_config(tmp_path, n=64, nt=50):
    return {
        "directory": str(tmp_path),
        "output": str(tmp_path / "output"),
        "logs": str(tmp_path / "output" / "logs"),
        "mesh": [
            {"direction": d, "start": -PI,
             "subDomains": [{"end": PI, "cells": n, "stretchRatio": 1.0}]}
            for d in ("x", "y")
        ],
        "flow": {
            "nu": 0.01,
            "initialVelocity": ["cos(x) * sin(y)", "- sin(x) * cos(y)"],
            "initialPressure": "- (cos(2*x) + cos(2*y)) / 4",
            "boundaryConditions": [
                {"location": loc, "u": ["PERIODIC", 0.0], "v": ["PERIODIC", 0.0]}
                for loc in ("xMinus", "xPlus", "yMinus", "yPlus")
            ],
        },
        "parameters": {
            "dt": 0.01, "nt": nt, "nsave": nt, "nrestart": nt,
            "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
            "velocitySolver": {"type": "CPU", "atol": 1e-10},
            "poissonSolver": {"type": "CPU", "atol": 1e-10},
        },
    }


@pytest.mark.slow
def test_taylor_green_analytic_decay(tmp_path):
    solver = NavierStokesSolver(tgv_config(tmp_path, n=64, nt=100))
    solver.run()
    solver.close()
    t, nu = 1.0, 0.01
    decay = np.exp(-2 * nu * t)
    mesh = solver.mesh
    xu = mesh.bcast(Field.U, 0, mesh.coord(Field.U, 0))
    yu = mesh.bcast(Field.U, 1, mesh.coord(Field.U, 1))
    u_exact = np.cos(xu) * np.sin(yu) * decay
    err = np.abs(np.asarray(solver.state["q"]["u"]) - u_exact)
    assert err.max() < 5e-4, f"TGV error {err.max():.2e}"


def cavity3d_config(tmp_path, n=12, nt=5):
    return {
        "directory": str(tmp_path),
        "output": str(tmp_path / "output"),
        "logs": str(tmp_path / "output" / "logs"),
        "mesh": [
            {"direction": d, "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": n, "stretchRatio": 1.0}]}
            for d in ("x", "y", "z")
        ],
        "flow": {
            "nu": 0.01,
            "initialVelocity": [0.0, 0.0, 0.0],
            "boundaryConditions": [
                {"location": loc,
                 "u": ["DIRICHLET", 1.0 if loc == "zPlus" else 0.0],
                 "v": ["DIRICHLET", 0.0],
                 "w": ["DIRICHLET", 0.0]}
                for loc in ("xMinus", "xPlus", "yMinus", "yPlus",
                            "zMinus", "zPlus")
            ],
        },
        "parameters": {
            "dt": 0.02, "nt": nt, "nsave": nt, "nrestart": nt,
            "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
            "velocitySolver": {"type": "CPU"},
            "poissonSolver": {"type": "CPU"},
        },
    }


def test_cavity3d_end_to_end(tmp_path):
    """3D lid-driven cavity (lid at zPlus moving +x): runs, stays
    divergence-free, writes 3D datasets."""
    solver = NavierStokesSolver(cavity3d_config(tmp_path))
    solver.run()
    solver.close()
    from petibm_jax.operators import make_divergence

    div = make_divergence(solver.mesh, solver.bc, solver.dtype)
    d = div(solver.state["q"], solver.state["bc"])
    assert float(jnp.max(jnp.abs(d))) < 1e-5
    u = np.asarray(solver.state["q"]["u"])
    assert u.shape == (12, 12, 11)
    # flow driven near the lid (top z layer moves +x)
    assert u[-1].mean() > u[:6].mean()
    with h5py.File(tmp_path / "output" / "0000005.h5") as fh:
        assert fh["u"].shape == (12, 12, 11)
        assert fh["w"].shape == (11, 12, 12)


def test_cavity3d_vorticity_and_probe(tmp_path):
    cfg = cavity3d_config(tmp_path, nt=3)
    cfg["probes"] = [{"type": "POINT", "field": "w", "path": "pw.txt",
                      "loc": [0.5, 0.5, 0.5]}]
    solver = NavierStokesSolver(cfg)
    solver.run()
    solver.close()
    from petibm_jax.io.vorticity import compute_vorticity

    w = compute_vorticity(solver.mesh, solver.bc, solver.state["q"],
                          solver.state["bc"])
    assert set(w) == {"wx", "wy", "wz"}
    assert w["wx"].shape == (13, 13, 12)
    assert np.loadtxt(tmp_path / "output" / "pw.txt").shape == (3, 2)


def test_taylor_green_spatial_convergence(tmp_path):
    """Observed order of accuracy ~2 between 16^2 and 32^2 (the reference's
    two-resolution convergence example,
    examples/navierstokes/convergence/liddrivencavity2dRe100_{20,30});
    dt is small enough that spatial error dominates."""
    errs = []
    for i, n in enumerate((16, 32)):
        d = tmp_path / f"n{n}"
        d.mkdir()
        cfg = tgv_config(d, n=n, nt=100)
        cfg["parameters"]["dt"] = 0.002
        solver = NavierStokesSolver(cfg)
        solver.run()
        solver.close()
        t, nu = 100 * 0.002, 0.01
        decay = np.exp(-2 * nu * t)
        mesh = solver.mesh
        xu = mesh.bcast(Field.U, 0, mesh.coord(Field.U, 0))
        yu = mesh.bcast(Field.U, 1, mesh.coord(Field.U, 1))
        u_exact = np.cos(xu) * np.sin(yu) * decay
        errs.append(np.abs(np.asarray(solver.state["q"]["u"]) - u_exact).max())
    order = np.log2(errs[0] / errs[1])
    assert order > 1.7, f"observed order {order:.2f} (errors {errs})"


def test_taylor_green_3d_analytic_decay(tmp_path):
    """3D periodic Taylor-Green (z-invariant mode): u = cos x sin y e^-2nut,
    w = 0 — exercises the full solver with three periodic directions
    (periodic FDM pressure + momentum transforms, periodic wraps in every
    operator) against the analytic decay (reference example:
    examples/navierstokes/taylorgreenvortex3dRe1600)."""
    n, nt, nu = 24, 20, 0.01
    cfg = {
        "directory": str(tmp_path),
        "output": str(tmp_path / "output"),
        "logs": str(tmp_path / "output" / "logs"),
        "mesh": [
            {"direction": d, "start": -PI,
             "subDomains": [{"end": PI, "cells": n, "stretchRatio": 1.0}]}
            for d in ("x", "y", "z")
        ],
        "flow": {
            "nu": nu,
            "initialVelocity": ["cos(x) * sin(y)", "- sin(x) * cos(y)", 0.0],
            "initialPressure": "- (cos(2*x) + cos(2*y)) / 4",
            "boundaryConditions": [
                {"location": loc, "u": ["PERIODIC", 0.0],
                 "v": ["PERIODIC", 0.0], "w": ["PERIODIC", 0.0]}
                for loc in ("xMinus", "xPlus", "yMinus", "yPlus",
                            "zMinus", "zPlus")
            ],
        },
        "parameters": {
            "dt": 0.01, "nt": nt, "nsave": nt, "nrestart": nt,
            "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
            "velocitySolver": {"type": "CPU", "atol": 1e-10, "rtol": 0.0},
            "poissonSolver": {"type": "CPU", "atol": 1e-10, "rtol": 0.0},
        },
    }
    solver = NavierStokesSolver(cfg)
    solver.run()
    solver.close()
    t = nt * 0.01
    decay = np.exp(-2 * nu * t)
    mesh = solver.mesh
    xu = mesh.bcast(Field.U, 0, mesh.coord(Field.U, 0))
    yu = mesh.bcast(Field.U, 1, mesh.coord(Field.U, 1))
    u_exact = np.broadcast_to(np.cos(xu) * np.sin(yu) * decay,
                              mesh.shape(Field.U))
    err = np.abs(np.asarray(solver.state["q"]["u"]) - u_exact)
    assert err.max() < 5e-3, f"3D TGV error {err.max():.2e}"
    assert np.abs(np.asarray(solver.state["q"]["w"])).max() < 1e-10
