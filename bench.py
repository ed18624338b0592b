"""Benchmark: decoupled-IBPM cylinder Re=200 on a 450x450 stretched grid.

This is BASELINE.json's headline configuration ("2D cylinder Re=200 on
stretched Cartesian grid").  Baseline anchor (BASELINE.md): the reference's
closest published number — 2D IBPM cylinder Re=550, 450x450 stretched,
1200 steps in < 5 min on 2 MPI ranks + 1 NVIDIA K40
(doc/markdowns/examples2d.md:133) — i.e. 250 ms per time step.

The full step (direct fast-diagonalization momentum and pressure solves
with warm-started recurrence-residual refinement at the reference's
atol 1e-6, setup-time-inverted dense EBNH force solve, projection) runs
jitted on one GPU, 1000 steps per dispatch (parameters.stepsPerDispatch —
lax.scan inside one XLA program; per-step solver stats still ride along).
Measurement starts after a 1000-step spin-up, so solver pass counts
reflect developed flow, not the uniform start, and every timed span ends
in ``block_until_ready``.  The hot operator (the negated pressure Poisson
apply) is also timed alone, as a chain inside one program, against the
card's data-sheet memory bandwidth.

Refuses to report off a GPU.  Prints ONE JSON line; vs_baseline > 1 means
faster than the reference's rate.
"""

import json
import math
import os
import sys
import tempfile
import time


def make_body(tmpdir: str, ds: float = 0.02) -> str:
    n = int(round(2 * math.pi * 0.5 / ds))
    path = os.path.join(tmpdir, "circle.body")
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for k in range(n):
            th = 2 * math.pi * k / n
            fh.write(f"{0.5 * math.cos(th):10.8e}\t{0.5 * math.sin(th):10.8e}\n")
    return path


def build_config(tmpdir: str) -> dict:
    axes = []
    for d in ("x", "y"):
        axes.append({
            "direction": d, "start": -15.0,
            "subDomains": [
                {"end": -0.6, "cells": 120, "stretchRatio": 0.975},
                {"end": 0.6, "cells": 120, "stretchRatio": 1.0},
                {"end": 15.0, "cells": 210, "stretchRatio": 1.02},
            ],
        })
    return {
        "directory": tmpdir,
        "output": os.path.join(tmpdir, "output"),
        "logs": os.path.join(tmpdir, "logs"),
        "mesh": axes,
        "flow": {
            "nu": 0.005,  # Re = 200 on D = 1, U = 1
            "initialVelocity": [1.0, 0.0],
            "boundaryConditions": [
                {"location": "xMinus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
                {"location": "xPlus", "u": ["CONVECTIVE", 1.0], "v": ["CONVECTIVE", 1.0]},
                {"location": "yMinus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
                {"location": "yPlus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
            ],
        },
        "parameters": {
            # dt follows the reference's 450^2 cylinder cases (Re550 uses
            # 0.0025 on this grid; explicit AB2 convection needs CFL < ~0.5)
            "dt": 0.0025, "nt": 10, "nsave": 0, "nrestart": 0,
            "dtype": "float32", "stepsPerDispatch": 1000,
            "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
            "velocitySolver": {"type": "CPU", "atol": 1e-6, "rtol": 1e-6,
                               "max_it": 1000},
            "poissonSolver": {"type": "CPU", "atol": 1e-6, "rtol": 1e-6,
                              "max_it": 5000},
            "forcesSolver": {"type": "CPU", "atol": 1e-6, "rtol": 1e-6,
                             "max_it": 1000},
        },
        "bodies": [{"type": "points", "file": make_body(tmpdir)}],
    }


def main() -> int:
    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from scripts.bench_spmv import (device_info, gpu_name_and_power_limit,
                                    marginal_apply_s, peak_bytes_per_s)

    device = device_info()
    if device["platform"] != "gpu":
        print(json.dumps({"ok": False, "error": "no GPU", "device": device}))
        return 1
    gpu = gpu_name_and_power_limit()

    from petibm_jax.solvers.decoupledibpm import DecoupledIBPMSolver

    tmpdir = tempfile.mkdtemp(prefix="petibm_bench_")
    solver = DecoupledIBPMSolver(build_config(tmpdir))

    k = solver.steps_per_dispatch
    warmup_chunks, chunks = 1, 2  # 1000 spin-up steps, 2000 measured
    state = solver.state
    for _ in range(warmup_chunks):
        state, stats = solver._chunk_fn(state)
    jax.block_until_ready(state)

    t0 = time.perf_counter()
    for _ in range(chunks):
        state, stats = solver._chunk_fn(state)
    jax.block_until_ready(state)
    elapsed = time.perf_counter() - t0
    # stats are stacked (k,) per chunk; report the last step's
    stats = {key: v[-1] for key, v in jax.device_get(stats).items()}
    ms_per_step = elapsed / (chunks * k) * 1e3
    baseline_ms = 250.0  # reference: 1200 steps < 5 min (2 MPI + K40)

    # the hot operator alone: phi and out are its only mandatory device-
    # memory traffic (the operator factors are 1D vectors)
    phi = state["p"]
    t_apply = marginal_apply_s(solver._negA_p, phi)
    apply_bytes = 2 * phi.size * phi.dtype.itemsize
    result = {
        "metric": "decoupled_ibpm_cylinder_re200_450sq_step_ms",
        "value": ms_per_step,
        "unit": "ms/step",
        "vs_baseline": baseline_ms / ms_per_step,
        "detail": {
            "device": device,
            "gpu": gpu,
            "dtype": "float32",
            "grid": "450x450 stretched, 157 body points",
            "v_iters": int(stats["v_iters"]),
            "p_iters": int(stats["p_iters"]),
            "f_iters": int(stats["f_iters"]),
            "p_res": float(stats["p_res"]),
            "steps_per_dispatch": k,
            "measured_after_steps": warmup_chunks * k,
            "poisson_apply_us": t_apply * 1e6,
            "poisson_apply_roofline_share":
                apply_bytes / peak_bytes_per_s() / t_apply,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
