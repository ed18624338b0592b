"""The stage profiler's phase decomposition must reproduce the production
step exactly — the phases re-express _build_step and would otherwise
silently drift (petibm_jax/utils/profiling.py)."""

import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from test_ibm import ib_config
from test_navierstokes import run_config


def compose_phases(solver, state, n):
    phases = [(name, jax.jit(fn)) for name, fn in solver._profile_phases()]
    for _ in range(n):
        ctx = {"state": state}
        for _, fn in phases:
            ctx, _probe = fn(ctx)
        state = ctx["state"]
    return state


def run_fused(solver, n):
    state = solver.state
    for _ in range(n):
        state, _stats = solver._step_fn(state)
    return state


def assert_states_match(a, b):
    fa = jax.tree_util.tree_leaves(a)
    fb = jax.tree_util.tree_leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        # 1e-10: the FDM preconditioner's dense matmuls may fuse (and so
        # reassociate their reductions) differently between the fused and
        # phase-split programs — a few-ULP effect; semantic drift between
        # the phase list and _build_step would show at >= 1e-6
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=0, atol=1e-10)


def test_phases_match_step_navierstokes(tmp_path):
    from petibm_jax.solvers.navierstokes import NavierStokesSolver

    solver = NavierStokesSolver(run_config(tmp_path, nt=3))
    assert_states_match(compose_phases(solver, solver.state, 3),
                        run_fused(solver, 3))
    solver.close()


def test_phases_match_step_decoupledibpm(tmp_path):
    from petibm_jax.solvers.decoupledibpm import DecoupledIBPMSolver

    solver = DecoupledIBPMSolver(ib_config(tmp_path, nt=3))
    assert_states_match(compose_phases(solver, solver.state, 3),
                        run_fused(solver, 3))
    solver.close()


def test_phases_match_step_ibpm(tmp_path):
    from petibm_jax.solvers.ibpm import IBPMSolver

    solver = IBPMSolver(ib_config(tmp_path, nt=3))
    assert_states_match(compose_phases(solver, solver.state, 3),
                        run_fused(solver, 3))
    solver.close()


def test_phases_match_step_rigidkinematics(tmp_path):
    from petibm_jax.solvers.rigidkinematics import RigidKinematicsSolver

    cfg = ib_config(tmp_path, nt=3)
    cfg["bodies"][0]["kinematics"] = {
        "type": "oscillation", "f": 0.2, "D": 0.4, "KC": 2.0}
    solver = RigidKinematicsSolver(cfg)
    assert_states_match(compose_phases(solver, solver.state, 3),
                        run_fused(solver, 3))
    solver.close()
