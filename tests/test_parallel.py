"""Multi-device domain decomposition: sharded runs must reproduce
single-device runs (SURVEY.md §4 multi-node story — run the suite on a
virtual 8-device CPU mesh; conftest forces
xla_force_host_platform_device_count=8)."""

import math
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from petibm_jax.parallel import mesh_from_config
from petibm_jax.solvers.decoupledibpm import DecoupledIBPMSolver
from petibm_jax.solvers.navierstokes import NavierStokesSolver

SHARDING = {"nDevices": 8, "platform": "cpu"}


def cavity_config(tmpdir, n=16, sharding=None):
    params = {
        "dt": 0.01, "nt": 10, "nsave": 10, "nrestart": 10,
        "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
        "velocitySolver": {"type": "CPU", "atol": 1e-12, "rtol": 0.0,
                           "max_it": 200},
        "poissonSolver": {"type": "CPU", "atol": 1e-12, "rtol": 0.0,
                          "max_it": 500},
    }
    if sharding:
        params["sharding"] = sharding
    return {
        "directory": tmpdir,
        "output": os.path.join(tmpdir, "output"),
        "logs": os.path.join(tmpdir, "logs"),
        "mesh": [
            {"direction": "x", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": n, "stretchRatio": 1.0}]},
            {"direction": "y", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": n, "stretchRatio": 1.05}]},
        ],
        "flow": {
            "nu": 0.01,
            "initialVelocity": [0.0, 0.0],
            "boundaryConditions": [
                {"location": "xMinus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
                {"location": "xPlus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
                {"location": "yMinus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
                {"location": "yPlus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
            ],
        },
        "parameters": params,
    }


def cylinder_config(tmpdir, sharding=None):
    n = 24
    path = os.path.join(tmpdir, "circle.body")
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for k in range(n):
            th = 2 * math.pi * k / n
            fh.write(f"{0.5 * math.cos(th):.8e}\t{0.5 * math.sin(th):.8e}\n")
    cfg = cavity_config(tmpdir, n=32, sharding=sharding)
    cfg["mesh"] = [
        {"direction": d, "start": -2.0,
         "subDomains": [{"end": 2.0, "cells": 32, "stretchRatio": 1.0}]}
        for d in ("x", "y")
    ]
    cfg["flow"] = {
        "nu": 0.025,
        "initialVelocity": [1.0, 0.0],
        "boundaryConditions": [
            {"location": "xMinus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
            {"location": "xPlus", "u": ["CONVECTIVE", 1.0], "v": ["CONVECTIVE", 1.0]},
            {"location": "yMinus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
            {"location": "yPlus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
        ],
    }
    cfg["parameters"]["dt"] = 0.005
    cfg["parameters"]["forcesSolver"] = {"type": "CPU", "atol": 1e-12,
                                         "rtol": 0.0, "max_it": 200}
    cfg["bodies"] = [{"type": "points", "file": path}]
    return cfg


def run_steps(solver, n):
    state = solver.state
    for _ in range(n):
        state, stats = solver._step_fn(state)
    return jax.block_until_ready(state)


def test_mesh_from_config():
    assert mesh_from_config(None) is None
    assert mesh_from_config({"nDevices": 1}) is None
    m = mesh_from_config(SHARDING)
    assert m.devices.size == 8 and m.axis_names == ("dy", "dx")
    m = mesh_from_config(dict(SHARDING, shape=[4, 2]))
    assert m.devices.shape == (4, 2)
    with pytest.raises(ValueError):
        mesh_from_config(dict(SHARDING, shape=[3, 2]))
    with pytest.raises(ValueError):
        mesh_from_config({"nDevices": 1000})


def test_cavity_sharded_matches_single():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref = NavierStokesSolver(cavity_config(d1))
        shd = NavierStokesSolver(cavity_config(d2, sharding=SHARDING))
        assert shd.sharding_mesh is not None
        s_ref = run_steps(ref, 10)
        s_shd = run_steps(shd, 10)
        # the pressure really is distributed over all 8 devices
        assert len(s_shd["p"].sharding.device_set) == 8
        for name in ("u", "v"):
            np.testing.assert_allclose(np.asarray(s_shd["q"][name]),
                                       np.asarray(s_ref["q"][name]),
                                       rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.asarray(s_shd["p"]),
                                   np.asarray(s_ref["p"]),
                                   rtol=0, atol=1e-10)


def test_decoupledibpm_sharded_matches_single():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref = DecoupledIBPMSolver(cylinder_config(d1))
        shd = DecoupledIBPMSolver(cylinder_config(d2, sharding=SHARDING))
        s_ref = run_steps(ref, 5)
        s_shd = run_steps(shd, 5)
        assert len(s_shd["p"].sharding.device_set) == 8
        # Lagrangian forces stay replicated but must agree
        np.testing.assert_allclose(np.asarray(s_shd["f"]),
                                   np.asarray(s_ref["f"]),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(np.asarray(s_shd["q"]["u"]),
                                   np.asarray(s_ref["q"]["u"]),
                                   rtol=0, atol=1e-9)


def sphere_config(tmpdir, sharding=None):
    """Small 3D decoupled-IBPM sphere (tests the z-local sharded layout
    claim of parallel/dist.py on a real 3D solve)."""
    from test_ibm import make_sphere_file

    import pathlib

    n = 16
    cfg = cavity_config(tmpdir, n=n, sharding=sharding)
    cfg["mesh"] = [
        {"direction": d, "start": 0.0,
         "subDomains": [{"end": 1.0, "cells": n, "stretchRatio": 1.0}]}
        for d in ("x", "y", "z")
    ]
    bcs = []
    for loc in ("xMinus", "yMinus", "yPlus", "zMinus", "zPlus"):
        bcs.append({"location": loc, "u": ["DIRICHLET", 1.0],
                    "v": ["DIRICHLET", 0.0], "w": ["DIRICHLET", 0.0]})
    bcs.append({"location": "xPlus", "u": ["CONVECTIVE", 1.0],
                "v": ["CONVECTIVE", 1.0], "w": ["CONVECTIVE", 1.0]})
    cfg["flow"] = {"nu": 0.02, "initialVelocity": [1.0, 0.0, 0.0],
                   "boundaryConditions": bcs}
    cfg["parameters"]["dt"] = 0.005
    cfg["parameters"]["forcesSolver"] = {"type": "CPU", "atol": 1e-12,
                                         "rtol": 0.0, "max_it": 200}
    body = make_sphere_file(pathlib.Path(tmpdir))
    cfg["bodies"] = [{"type": "points", "file": body}]
    return cfg


def test_decoupledibpm_3d_sharded_matches_single():
    """3D sharded equivalence: (ny, nx) sharded over the ("dy","dx") mesh,
    z local — the layout parallel/dist.py documents."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref = DecoupledIBPMSolver(sphere_config(d1))
        shd = DecoupledIBPMSolver(sphere_config(d2, sharding=SHARDING))
        s_ref = run_steps(ref, 3)
        s_shd = run_steps(shd, 3)
        assert len(s_shd["p"].sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(s_shd["f"]),
                                   np.asarray(s_ref["f"]),
                                   rtol=0, atol=1e-9)
        for name in ("u", "v", "w"):
            np.testing.assert_allclose(np.asarray(s_shd["q"][name]),
                                       np.asarray(s_ref["q"][name]),
                                       rtol=0, atol=1e-9)
        np.testing.assert_allclose(np.asarray(s_shd["p"]),
                                   np.asarray(s_ref["p"]),
                                   rtol=0, atol=1e-9)


def test_ibpm_coupled_sharded_matches_single():
    """The coupled {p, f} block solve under the 8-device mesh."""
    from petibm_jax.solvers.ibpm import IBPMSolver

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref = IBPMSolver(cylinder_config(d1))
        shd = IBPMSolver(cylinder_config(d2, sharding=SHARDING))
        s_ref = run_steps(ref, 5)
        s_shd = run_steps(shd, 5)
        assert len(s_shd["p"].sharding.device_set) == 8
        # the coupled Krylov solve amplifies reduction-order noise into the
        # O(30)-magnitude forces; compare relative, not absolute
        np.testing.assert_allclose(np.asarray(s_shd["f"]),
                                   np.asarray(s_ref["f"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(s_shd["q"]["u"]),
                                   np.asarray(s_ref["q"]["u"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(s_shd["p"]),
                                   np.asarray(s_ref["p"]),
                                   rtol=1e-6, atol=1e-6)


def test_rigidkinematics_sharded_matches_single():
    """Moving-body windows recomputed inside the sharded jitted step."""
    from petibm_jax.solvers.rigidkinematics import RigidKinematicsSolver

    def config(d, sharding=None):
        cfg = cylinder_config(d, sharding=sharding)
        cfg["bodies"][0]["kinematics"] = {
            "type": "oscillation", "f": 0.2, "D": 0.4, "KC": 2.0}
        return cfg

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref = RigidKinematicsSolver(config(d1))
        shd = RigidKinematicsSolver(config(d2, sharding=SHARDING))
        s_ref = run_steps(ref, 3)
        s_shd = run_steps(shd, 3)
        assert len(s_shd["p"].sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(s_shd["f"]),
                                   np.asarray(s_ref["f"]),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(np.asarray(s_shd["q"]["u"]),
                                   np.asarray(s_ref["q"]["u"]),
                                   rtol=0, atol=1e-9)


def test_decoupledibpm_3axis_mesh_matches_single():
    """3-axis ("dz","dy","dx") decomposition (sharding.shape: [2, 2, 2]):
    the z direction is sharded too — the layout a multi-host 3D run
    wants — and the physics is identical."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref = DecoupledIBPMSolver(sphere_config(d1))
        shd = DecoupledIBPMSolver(sphere_config(
            d2, sharding={"platform": "cpu", "shape": [2, 2, 2]}))
        assert shd.sharding_mesh.axis_names == ("dz", "dy", "dx")
        s_ref = run_steps(ref, 3)
        s_shd = run_steps(shd, 3)
        assert len(s_shd["p"].sharding.device_set) == 8
        for name in ("u", "v", "w"):
            np.testing.assert_allclose(np.asarray(s_shd["q"][name]),
                                       np.asarray(s_ref["q"][name]),
                                       rtol=0, atol=1e-9)
        np.testing.assert_allclose(np.asarray(s_shd["p"]),
                                   np.asarray(s_ref["p"]),
                                   rtol=0, atol=1e-9)
