"""Device time of the hot stencil operators and the line smoother's
tridiagonal solve, as XLA compiles them, against the memory roofline.

Every operator here is bandwidth-bound: per call it has to read its input
arrays and write its outputs once (the operator coefficients are 1D
factors that fuse into the loops).  The roofline time of one apply is those
bytes over the card's data-sheet bandwidth (``PEAK_BYTES_PER_S``, keyed by
``device_kind``); the share printed is roofline time over measured time.

Each apply is timed as a chain of K applies inside one jitted program, for
two values of K; the slope is the marginal device time of one apply, free
of dispatch and synchronisation.  Timing ends in ``block_until_ready``.

    python scripts/bench_spmv.py             # operator table (GPU only)
    python scripts/bench_spmv.py --setup     # construction time of the
                                             # 450^2 decoupled-IBPM solver

Prints one JSON line per measurement.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

#: data-sheet device-memory bandwidth (bytes/s) by ``device_kind``:
#: NVIDIA H100 SXM5 80 GB (HBM3) data sheet, 3.35 TB/s
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_info() -> dict:
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi``'s name and power limit of the first GPU, if any."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def peak_bytes_per_s() -> float:
    kind = jax.devices()[0].device_kind
    if kind not in PEAK_BYTES_PER_S:
        raise KeyError(f"no data-sheet bandwidth for device {kind!r}")
    return PEAK_BYTES_PER_S[kind]


def _ready(x):
    return jax.block_until_ready(x)


def time_chain(fn, x, K: int, repeats: int = 5) -> float:
    """Seconds per program of K chained applies x <- fn(x) (median)."""
    run = jax.jit(lambda p: jax.lax.fori_loop(0, K, lambda i, y: fn(y), p))
    out = _ready(run(x))  # compile + warm up
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = _ready(run(out))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def marginal_apply_s(fn, x, k_lo: int = 16, k_hi: int = 256) -> float:
    """Marginal device seconds of one apply: the K-chain slope."""
    return (time_chain(fn, x, k_hi) - time_chain(fn, x, k_lo)) / (k_hi - k_lo)


def tree_bytes(tree) -> int:
    return sum(int(leaf.size) * leaf.dtype.itemsize
               for leaf in jax.tree_util.tree_leaves(tree))


def stream_bw_bytes_per_s(shape=(8192, 8192), dtype=jnp.float32,
                          chain: int = 100, repeats: int = 3) -> float:
    """Measured device-memory bandwidth of a chained x = 2x + y stream
    (reads x and y, writes x) over a 512 MB working set, far above the
    last-level cache."""
    y = jnp.full(shape, 1e-9, dtype)

    @jax.jit
    def run(x):
        return jax.lax.fori_loop(0, chain, lambda i, v: 2.0 * v + y, x)

    x = _ready(run(jnp.zeros(shape, dtype)))
    t0 = time.perf_counter()
    for _ in range(repeats):
        x = run(x)
    _ready(x)
    dt = time.perf_counter() - t0
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return 3 * nbytes * chain * repeats / dt


# ----------------------------------------------------------------------
def _box_config(cells, periodic: bool, out: str) -> dict:
    """A uniform box (2D or 3D), all-periodic or lid-driven walls."""
    names = "xyz"[:len(cells)]
    comps = "uvw"[:len(cells)]
    mesh = [{"direction": d, "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": n, "stretchRatio": 1.0}]}
            for d, n in zip(names, cells)]
    bcs = []
    for d in names:
        for side in ("Minus", "Plus"):
            kind = "PERIODIC" if periodic else "DIRICHLET"
            lid = 1.0 if (not periodic and d == names[1] and side == "Plus") else 0.0
            bcs.append({"location": d + side,
                        **{c: [kind, lid if c == "u" else 0.0] for c in comps}})
    return {"mesh": mesh, "output": out, "logs": out,
            "flow": {"nu": 0.01, "initialVelocity": [0.0] * len(cells),
                     "boundaryConditions": bcs},
            "parameters": {"dt": 0.01, "nt": 1, "nsave": 0, "nrestart": 0,
                           "dtype": "float32"}}


def _case_config(directory: str, out: str) -> dict:
    from petibm_jax.config import load_config

    cfg = load_config(directory=directory, output=out, logs=out)
    cfg["parameters"].update(nsave=0, nrestart=0, nt=1, dtype="float32")
    return cfg


def _solver(cfg):
    from petibm_jax.solvers.navierstokes import NavierStokesSolver

    return NavierStokesSolver(cfg)


def _row(op, grid, t, nbytes, peak, extra=None):
    row = {"op": op, "grid": grid, "us_per_apply": t * 1e6,
           "bytes_per_apply": nbytes,
           "roofline_share": nbytes / peak / t if t > 0 else None}
    row.update(extra or {})
    print(json.dumps(row), flush=True)
    return row


def operator_table() -> list:
    peak = peak_bytes_per_s()
    rows = []
    out = tempfile.mkdtemp(prefix="petibm_ops_")
    cases = [
        ("450x450 stretched", lambda: _case_config(
            os.path.join(ROOT, "examples/decoupledibpm/cylinder2dRe200"),
            out), ("poisson",)),
        ("1024x1024 uniform walls", lambda: _box_config((1024, 1024), False,
                                                        out), ("poisson",)),
        ("160x130x130 stretched", lambda: _case_config(
            os.path.join(ROOT, "examples/decoupledibpm/sphere3dRe300"), out),
         ("poisson", "momentum", "convection")),
        ("256^3 periodic", lambda: _box_config((256, 256, 256), True, out),
         ("poisson", "momentum", "convection")),
    ]
    for grid, make_cfg, ops in cases:
        s = _solver(make_cfg())
        q, p, bc = s.state["q"], s.state["p"], s.state["bc"]
        rng = np.random.default_rng(0)
        p = jnp.asarray(rng.standard_normal(p.shape), jnp.float32)
        q = {k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
             for k, v in q.items()}
        for op in ops:
            if op == "poisson":
                fn, x = s._negA_p, p
            elif op == "momentum":
                fn, x = s.A_momentum, q
            else:
                fn, x = (lambda u, s=s, bc=bc: s.convect(u, bc)), q
            t = marginal_apply_s(fn, x)
            rows.append(_row(op, grid, t, 2 * tree_bytes(x), peak))
        del s
    rows += tridiag_ab(peak)
    return rows


def tridiag_ab(peak: float) -> list:
    """The MG line smoother's batched tridiagonal solve: jnp PCR
    (linalg/tridiag.py) against lax.linalg.tridiagonal_solve, on random
    diagonally dominant systems shaped like one 2D sweep (n lines of
    length n), and whole MG line sweeps of a PoissonMG finest level."""
    from jax.lax.linalg import tridiagonal_solve

    from petibm_jax.linalg.mg import PoissonMG
    from petibm_jax.linalg.tridiag import tridiag_solve_pcr

    rows = []
    rng = np.random.default_rng(1)
    for n in (450, 256):
        a = -rng.uniform(0.5, 1.0, (n, n)).astype(np.float32)
        c = -rng.uniform(0.5, 1.0, (n, n)).astype(np.float32)
        b = (np.abs(a) + np.abs(c) + rng.uniform(0.1, 1.0, (n, n))).astype(
            np.float32)
        d = rng.standard_normal((n, n)).astype(np.float32)
        a, b, c, d = map(jnp.asarray, (a, b, c, d))
        pcr = lambda x: tridiag_solve_pcr(a, b, c, x)
        lax_ts = lambda x: tridiagonal_solve(a, b, c, x[..., None])[..., 0]
        err = float(jnp.max(jnp.abs(jax.jit(pcr)(d) - jax.jit(lax_ts)(d))))
        # 4 arrays in (3 coefficient + rhs), 1 out
        nbytes = 5 * n * n * 4
        for name, fn in (("tridiag_pcr", pcr), ("tridiag_lax", lax_ts)):
            rows.append(_row(name, f"{n}x{n}", marginal_apply_s(fn, d),
                             nbytes, peak, {"max_abs_diff": err}))
    for shape in ((450, 450), (130, 130, 160)):
        dxs = [np.geomspace(1.0, 1.5, n) / n for n in shape]
        mg = PoissonMG(dxs, [False] * len(shape), dtype=jnp.float32)
        phi = jnp.asarray(rng.standard_normal(tuple(reversed(shape))),
                          jnp.float32)
        rhs = jnp.asarray(rng.standard_normal(phi.shape), jnp.float32)
        grid = "x".join(str(n) for n in reversed(shape))
        for use_pcr in (True, False):
            mg.use_pcr = use_pcr
            fn = lambda x, mg=mg: mg.smooth(0, x, rhs, 1)
            rows.append(_row(
                "mg_sweep_" + ("pcr" if use_pcr else "lax"), grid,
                marginal_apply_s(fn, phi, 4, 36), 3 * int(phi.size) * 4
                * len(shape), peak))
    return rows


def setup_time() -> dict:
    """Construction time of the 450^2 decoupled-IBPM solver (bench.py's
    configuration) in this process, under PETIBM_SETUP_DEVICE as set."""
    import bench
    from petibm_jax.solvers.decoupledibpm import DecoupledIBPMSolver

    tmp = tempfile.mkdtemp(prefix="petibm_setup_")
    cfg = bench.build_config(tmp)
    t0 = time.perf_counter()
    solver = DecoupledIBPMSolver(cfg)
    jax.block_until_ready(solver.state)
    t_init = time.perf_counter() - t0
    row = {"op": "setup_450sq_decoupled",
           "setup_device": os.environ.get("PETIBM_SETUP_DEVICE", "cpu"),
           "init_s": t_init, **device_info()}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    info = device_info()
    if info["platform"] != "gpu":
        print(json.dumps({"ok": False, "error": "no GPU found",
                          "device": info}))
        return 1
    if "--setup" in sys.argv:
        setup_time()
        return 0
    print(json.dumps({"device": info,
                      "stream_bytes_per_s": stream_bw_bytes_per_s(),
                      "peak_bytes_per_s": peak_bytes_per_s()}), flush=True)
    operator_table()
    return 0


if __name__ == "__main__":
    sys.exit(main())
