"""Geometric multigrid tests: V-cycle contraction, MGCG iteration counts
vs Jacobi-CG, correctness vs the matrix-free Poisson operator, periodic
and stretched grids, odd sizes, 3D."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from petibm_jax.boundary import BoundarySet
from petibm_jax.linalg import cg
from petibm_jax.linalg.mg import PoissonMG
from petibm_jax.mesh import StaggeredMesh
from petibm_jax.operators import make_bn, make_divergence, make_gradient, make_laplacian
from petibm_jax.types import Field

from test_mesh import cavity_config, periodic_config

F64 = jnp.float64


def neg_poisson(mesh, bcs, dt=1.0):
    grad = make_gradient(mesh, F64)
    div = make_divergence(mesh, bcs, F64)
    lap = make_laplacian(mesh, bcs, F64)
    bn = make_bn(lap, dt, 0.0, 1)

    def negA(phi):
        return -div(bn(grad(phi)), None, homogeneous=True)

    return negA


def mean_zero_rhs(shape, seed=0):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(shape)
    return jnp.asarray(b - b.mean())


def test_mg_level_op_matches_fine_operator():
    """Level-0 MG operator == the matrix-free -D B1 G for interior-consistent
    configs (the zero-flux wall condition is exactly the a0=0 folding)."""
    cfg = cavity_config(12, 10)
    cfg["mesh"][0]["subDomains"][0]["stretchRatio"] = 1.2
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    negA = neg_poisson(mesh, bcs, dt=0.02)
    mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=F64, scale=0.02)
    rng = np.random.default_rng(1)
    phi = jnp.asarray(rng.standard_normal(mesh.shape(Field.P)))
    np.testing.assert_allclose(np.asarray(mg.apply_op(0, phi)),
                               np.asarray(negA(phi)), rtol=1e-12, atol=1e-14)


def test_mg_level_op_matches_periodic():
    cfg = periodic_config(8, 6)
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    negA = neg_poisson(mesh, bcs)
    mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=F64)
    rng = np.random.default_rng(2)
    phi = jnp.asarray(rng.standard_normal(mesh.shape(Field.P)))
    np.testing.assert_allclose(np.asarray(mg.apply_op(0, phi)),
                               np.asarray(negA(phi)), rtol=1e-12, atol=1e-14)


def test_mgcg_uniform():
    """MG quality contract on a uniform grid: the V-cycle preconditioner
    (PWC transfers + alternating-line smoothing) holds CG to a small
    iteration count where Jacobi-CG needs hundreds."""
    cfg = cavity_config(64, 64)
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    negA = neg_poisson(mesh, bcs)
    mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=F64)
    assert len(mg.levels) >= 4
    b = mean_zero_rhs(mesh.shape(Field.P))
    res = cg(negA, b, jnp.zeros_like(b), M=mg.preconditioner(),
             atol=1e-8, rtol=0.0, maxiter=100)
    assert bool(res.converged)
    assert int(res.iters) <= 25, f"MGCG took {int(res.iters)} iterations"


def test_mgcg_beats_jacobi_cg():
    cfg = cavity_config(96, 96)
    cfg["mesh"][0]["subDomains"] = [
        {"end": 0.4, "cells": 48, "stretchRatio": 0.97},
        {"end": 1.0, "cells": 48, "stretchRatio": 1.03},
    ]
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    negA = neg_poisson(mesh, bcs)
    mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=F64)
    b = mean_zero_rhs(mesh.shape(Field.P), seed=3)
    res = cg(negA, b, jnp.zeros_like(b), M=mg.preconditioner(),
             atol=1e-8, rtol=0.0, maxiter=100)
    assert bool(res.converged)
    # stretched anisotropic grid: line-smoothed MGCG holds ~35 iterations
    # where Jacobi-CG needs several hundred
    assert int(res.iters) <= 40, f"MGCG took {int(res.iters)} iterations"
    np.testing.assert_allclose(np.asarray(negA(res.x)), np.asarray(b),
                               atol=1e-7)


def test_mgcg_periodic():
    cfg = periodic_config(64, 64)
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    negA = neg_poisson(mesh, bcs)
    mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=F64)
    b = mean_zero_rhs(mesh.shape(Field.P), seed=4)
    res = cg(negA, b, jnp.zeros_like(b), M=mg.preconditioner(),
             atol=1e-8, rtol=0.0, maxiter=100)
    assert bool(res.converged) and int(res.iters) <= 30


def test_mgcg_odd_size_3d():
    cfg = {
        "mesh": [
            {"direction": "x", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": 21, "stretchRatio": 1.0}]},
            {"direction": "y", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": 18, "stretchRatio": 1.05}]},
            {"direction": "z", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": 13, "stretchRatio": 1.0}]},
        ],
        "flow": {"nu": 0.01, "initialVelocity": [0, 0, 0],
                 "boundaryConditions": [
                     {"location": loc, "u": ["DIRICHLET", 0.0],
                      "v": ["DIRICHLET", 0.0], "w": ["DIRICHLET", 0.0]}
                     for loc in ("xMinus", "xPlus", "yMinus", "yPlus",
                                 "zMinus", "zPlus")]},
    }
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    negA = neg_poisson(mesh, bcs)
    mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=F64)
    b = mean_zero_rhs(mesh.shape(Field.P), seed=5)
    res = cg(negA, b, jnp.zeros_like(b), M=mg.preconditioner(),
             atol=1e-8, rtol=0.0, maxiter=100)
    assert bool(res.converged) and int(res.iters) <= 15


def test_mixed_precision_vcycle_preconditioner(tmp_path):
    """mg: {dtype: bfloat16} runs the V-cycle in bf16 while CG stays in the
    solver dtype: the converged solution matches the full-precision
    preconditioner (preconditioning affects iteration count only)."""
    import sys as _sys

    _sys.path.insert(0, os.path.dirname(__file__))
    from test_navierstokes import run_config
    from petibm_jax.solvers.navierstokes import NavierStokesSolver

    cfg_a = run_config(tmp_path / "a", nt=10)
    cfg_a["parameters"]["dtype"] = "float32"
    cfg_b = run_config(tmp_path / "b", nt=10)
    cfg_b["parameters"]["dtype"] = "float32"
    cfg_b["parameters"]["mg"] = {"dtype": "bfloat16"}
    # this test targets the CG+MG path; opt out of the FDM default
    cfg_a["parameters"]["fdm"] = False
    cfg_b["parameters"]["fdm"] = False
    for d in ("a", "b"):
        os.makedirs(tmp_path / d, exist_ok=True)
    sa = NavierStokesSolver(cfg_a)
    sb = NavierStokesSolver(cfg_b)
    assert getattr(sb, "poisson_mg_lp", None) is not None
    assert sb.poisson_mg_lp.dtype == jnp.bfloat16
    for _ in range(10):
        sa.state, stats_a = sa._step_fn(sa.state)
        sb.state, stats_b = sb._step_fn(sb.state)
    import jax

    stats_a, stats_b = jax.device_get((stats_a, stats_b))
    assert bool(stats_b["p_ok"])  # bf16 cycle still converges the f32 CG
    # same operator, same tolerance -> same physics
    np.testing.assert_allclose(np.asarray(sb.state["p"]),
                               np.asarray(sa.state["p"]),
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(np.asarray(sb.state["q"]["u"]),
                               np.asarray(sa.state["q"]["u"]),
                               rtol=0, atol=5e-6)
    sa.close(), sb.close()


def test_sharded_mg_coarse_consolidation_equivalence():
    """Distributed MG with replicated (consolidated) coarse levels matches
    the unsharded solve bit-for-tolerance: consolidation only changes the
    layout, never the math (the AmgX rank-consolidation analogue,
    linsolveramgx.cpp:54-126)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from petibm_jax.linalg.krylov import cg

    n = 64
    dxp = [np.full(n, 1.0 / n), np.full(n, 1.0 / n)]
    rng = np.random.default_rng(2)
    b0 = rng.standard_normal((n, n))
    b0 -= b0.mean()

    def solve(mesh_devices):
        mg = PoissonMG(dxp, [False, False], dtype=F64, scale=0.01,
                       consolidate_below=256)
        b = jnp.asarray(b0)
        if mesh_devices is not None:
            mesh = Mesh(mesh_devices, ("dy", "dx"))
            mg.set_mesh(mesh)
            b = jax.device_put(b, NamedSharding(mesh, P("dy", "dx")))
        res = jax.jit(lambda b: cg(lambda p: mg.apply_op(0, p), b,
                                   jnp.zeros_like(b),
                                   M=mg.preconditioner(),
                                   atol=1e-10, maxiter=200))(b)
        return np.asarray(res.x), int(res.iters)

    x1, it1 = solve(None)
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    x8, it8 = solve(devs)
    np.testing.assert_allclose(x8 - x8.mean(), x1 - x1.mean(), atol=1e-9)
    assert abs(it8 - it1) <= 1  # same preconditioner quality
