"""Real multi-process jax.distributed execution.

Spawns TWO localhost processes that each run the production solver path
with ``parameters.distributed`` — so ``jax.distributed.initialize``
(parallel/multihost.py:86) actually executes, the global mesh spans both
processes (4 virtual CPU devices each, 8 global), and the sharded cavity
solve halo-exchanges across the process boundary.  Both processes must
agree with each other and with a single-process unsharded run — the
analogue of the reference's MPI-rank-count invariance
(PetscInitialize in applications/navierstokes/main.cpp:45-50, DMDA
decomposition cartesianmesh.cpp:492-538).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_cavity(tmp_path):
    coordinator = f"localhost:{_free_port()}"
    env = dict(os.environ)
    # the workers set their own JAX/XLA env; scrub inherited test settings
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, "2", str(pid),
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("MHRESULT ")]
            assert lines, f"no MHRESULT line:\n{out}\n{err}"
            outs.append(json.loads(lines[-1][len("MHRESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    a, b = sorted(outs, key=lambda d: d["process_id"])
    assert (a["process_id"], b["process_id"]) == (0, 1)
    for d in outs:
        assert d["n_processes"] == 2
        assert d["n_devices"] == 8
        assert d["p_ok"]
    # both processes computed the same global solution
    for key in ("p_mean_abs", "u_norm", "v_norm"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-12)

    # cross-check against a single-process, unsharded run of the same
    # case inside this test process (x64, tight tolerances): rank-count
    # invariance of the physics
    from _multihost_worker import config as worker_config

    import jax

    from petibm_jax.solvers.navierstokes import NavierStokesSolver

    outdir = str(tmp_path / "single")
    os.makedirs(outdir, exist_ok=True)
    cfg = worker_config(outdir)
    cfg["parameters"].pop("distributed", None)
    cfg["parameters"].pop("sharding", None)
    solver = NavierStokesSolver(cfg)
    for _ in range(5):
        solver.state, _stats = solver._step_fn(solver.state)
    p = solver.state["p"]
    diags = {
        "p_mean_abs": float(jax.numpy.mean(jax.numpy.abs(p - p.mean()))),
        "u_norm": float(jax.numpy.linalg.norm(solver.state["q"]["u"].ravel())),
        "v_norm": float(jax.numpy.linalg.norm(solver.state["q"]["v"].ravel())),
    }
    solver.close()
    for key in ("p_mean_abs", "u_norm", "v_norm"):
        np.testing.assert_allclose(a[key], diags[key], rtol=1e-9)
