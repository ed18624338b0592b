"""Worker process for tests/test_multihost.py: one of two localhost
jax.distributed processes running a sharded cavity through the production
solver path (the analogue of one MPI rank in the reference's
PetscInitialize bring-up, applications/navierstokes/main.cpp:45-50).

Invoked as:  python _multihost_worker.py <coordinator> <num_procs> <pid> <tmpdir>

The process contributes its virtual CPU devices to the global mesh; the
``parameters.distributed`` node routes through
petibm_jax.parallel.multihost.maybe_initialize, so jax.distributed
.initialize (multihost.py:86) actually executes.  Prints one line
``MHRESULT {json}`` with replicated scalar diagnostics of the final state.
"""

import json
import os
import sys


def config(outdir, coordinator=None, nproc=None, pid=None):
    """16^2 cavity; adds the distributed/sharding nodes when a
    coordinator is given (the test imports this for its single-process
    cross-check)."""
    n = 16
    params = {
        "dt": 0.01, "nt": 5, "nsave": 100, "nrestart": 100,
        "poissonSolver": {"type": "CPU", "atol": 1e-10, "rtol": 0.0},
        "velocitySolver": {"type": "CPU", "atol": 1e-10, "rtol": 0.0},
    }
    if coordinator is not None:
        params["distributed"] = {"coordinator": coordinator,
                                 "numProcesses": nproc, "processId": pid}
        params["sharding"] = {"platform": "cpu"}
    return {
        "directory": outdir, "output": outdir,
        "logs": os.path.join(outdir, "logs"),
        "mesh": [
            {"direction": "x", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": n, "stretchRatio": 1.0}]},
            {"direction": "y", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": n, "stretchRatio": 1.0}]},
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
        "parameters": params,
    }


def main() -> None:
    coordinator, nproc, pid, tmpdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

    # CPU backend with 4 local virtual devices per process (8 global);
    # a test process never opens an accelerator
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()
    os.environ["JAX_ENABLE_X64"] = "1"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    from petibm_jax.parallel import multihost
    from petibm_jax.solvers.navierstokes import NavierStokesSolver

    outdir = os.path.join(tmpdir, f"proc{pid}")
    os.makedirs(outdir, exist_ok=True)
    solver = NavierStokesSolver(config(outdir, coordinator, nproc, pid))

    assert multihost.is_initialized()
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 4 * nproc, jax.device_count()
    assert solver.sharding_mesh is not None
    assert solver.sharding_mesh.devices.size == 4 * nproc
    # the mesh must actually span both processes
    procs = {d.process_index for d in solver.sharding_mesh.devices.flat}
    assert procs == set(range(nproc)), procs

    # host-local numpy inputs are treated as fully-replicated global
    # arrays by the jitted sharded step (every process passes identical
    # values)
    solver.state = jax.tree_util.tree_map(np.asarray, solver.state)

    for _ in range(5):
        solver.state, stats = solver._step_fn(solver.state)

    jnp = jax.numpy
    diag_fn = jax.jit(lambda s: {
        "p_mean_abs": jnp.mean(jnp.abs(s["p"] - jnp.mean(s["p"]))),
        "u_norm": jnp.linalg.norm(s["q"]["u"].ravel()),
        "v_norm": jnp.linalg.norm(s["q"]["v"].ravel()),
    })
    diags = {k: float(v) for k, v in
             jax.device_get(diag_fn(solver.state)).items()}
    diags["v_iters"] = int(jax.device_get(stats["v_iters"]))
    diags["p_ok"] = bool(jax.device_get(stats["p_ok"]))
    diags["process_id"] = pid
    diags["n_processes"] = int(jax.process_count())
    diags["n_devices"] = int(jax.device_count())
    solver.close()
    print("MHRESULT " + json.dumps(diags), flush=True)


if __name__ == "__main__":
    main()
