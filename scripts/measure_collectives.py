"""Communication profile of the sharded step from the partitioned HLO.

The one-chip environment cannot measure multi-device wall-clock, but the
GSPMD-partitioned program is exact: this script compiles the FULL
decoupled-IBPM step over an 8-virtual-device CPU mesh for each pressure
path — (a) the default direct fast-diagonalization solve and (b) the
MG-preconditioned CG — in 2D and 3D, counts every collective op in the
compiled module (all-reduce / all-gather / all-to-all /
collective-permute / reduce-scatter, including -start variants), sums
their payload bytes, and records the largest single transfer.

Static counts: collectives inside while-loop bodies (Krylov iterations,
refinement passes) appear once; docs/distributed.md multiplies by the
measured per-step iteration counts from the validation records when
building the interconnect roofline model.

Run in a fresh process (forces CPU + 8 virtual devices):

  python scripts/measure_collectives.py
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "c64": 8,
               "c128": 16, "s32": 4, "u32": 4, "s64": 8, "u64": 8,
               "pred": 1, "s8": 1, "u8": 1}

COLLECTIVES = ("all-reduce", "all-gather", "all-to-all",
               "collective-permute", "reduce-scatter")


def shape_bytes(result: str) -> int:
    """Total payload bytes of an HLO result type (tuples summed)."""
    total = 0
    for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", result):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def count_collectives(hlo: str) -> dict:
    ops: dict[str, dict] = {}
    largest = {"op": None, "bytes": 0}
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?%?\S+\s*=\s*(\([^)]*\)|\S+)\s+"
                     r"(all-reduce|all-gather|all-to-all|collective-permute|"
                     r"reduce-scatter)(?:-start)?\(", line)
        if not m:
            continue
        result, op = m.group(1), m.group(2)
        b = shape_bytes(result)
        rec = ops.setdefault(op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += b
        if b > largest["bytes"]:
            largest = {"op": op, "bytes": b}
    return {"ops": ops,
            "total_count": sum(r["count"] for r in ops.values()),
            "total_bytes": sum(r["bytes"] for r in ops.values()),
            "largest_single": largest}


def build_solver(dim: int, variant: str, n2d: int = 128, n3d: int = 48):
    sys.path.insert(0, REPO)
    import __graft_entry__ as ge
    from petibm_jax.solvers.decoupledibpm import DecoupledIBPMSolver

    tmpdir = tempfile.mkdtemp(prefix="petibm_collect_")
    os.makedirs(os.path.join(tmpdir, "output"), exist_ok=True)
    os.makedirs(os.path.join(tmpdir, "logs"), exist_ok=True)
    cfg = ge._cylinder_config(n2d, tmpdir)
    if dim == 3:
        # extrude: cylinder -> periodic-z column of points
        cfg["mesh"].append({"direction": "z", "start": -1.0, "subDomains": [
            {"end": 1.0, "cells": n3d, "stretchRatio": 1.0}]})
        cfg["mesh"][0]["subDomains"][0]["cells"] = n3d
        cfg["mesh"][1]["subDomains"][0]["cells"] = n3d
        cfg["flow"]["boundaryConditions"].append(
            {"location": "zMinus", "u": ["PERIODIC", 0.0],
             "v": ["PERIODIC", 0.0], "w": ["PERIODIC", 0.0]})
        cfg["flow"]["boundaryConditions"].append(
            {"location": "zPlus", "u": ["PERIODIC", 0.0],
             "v": ["PERIODIC", 0.0], "w": ["PERIODIC", 0.0]})
        for bc in cfg["flow"]["boundaryConditions"][:4]:
            bc["w"] = ["DIRICHLET", 0.0]
        cfg["flow"]["initialVelocity"] = [1.0, 0.0, 0.0]
        npts = 24
        body = os.path.join(tmpdir, "column.body")
        import math
        with open(body, "w") as fh:
            fh.write(f"{npts}\n")
            for k in range(npts):
                th = 2 * math.pi * k / npts
                fh.write(f"{0.5 * math.cos(th):.8e}\t"
                         f"{0.5 * math.sin(th):.8e}\t0.0\n")
        cfg["bodies"] = [{"type": "points", "file": body}]
    cfg["parameters"]["sharding"] = {"nDevices": 8}
    if variant == "mgcg":
        cfg["parameters"]["fdm"] = False
    elif variant == "fdm-naive":
        cfg["parameters"]["fdm"] = {"repartition": False}
    return DecoupledIBPMSolver(cfg)


def profile(dim: int, variant: str) -> dict:
    solver = build_solver(dim, variant)
    hlo = solver._step_fn.lower(solver.state).compile().as_text()
    stats = count_collectives(hlo)
    # grid reference scale: bytes of one replicated pressure field
    import numpy as np

    from petibm_jax.types import Field

    pbytes = int(np.prod(solver.mesh.shape(Field.P))) * 4
    out = {
        "case": f"decoupled_ibpm_{dim}d_{variant}",
        "grid": "x".join(str(s) for s in solver.mesh.shape(Field.P)[::-1]),
        "devices": 8,
        "pressure_path": variant,
        "p_field_bytes": pbytes,
        **stats,
    }
    solver.close()
    return out


def main() -> int:
    results = []
    for dim in (2, 3):
        for variant in ("fdm", "fdm-naive", "mgcg"):
            r = profile(dim, variant)
            r["largest_vs_p_field"] = round(
                r["largest_single"]["bytes"] / r["p_field_bytes"], 3)
            print(json.dumps(r))
            results.append(r)
    path = os.path.join(REPO, "validation", "collectives.json")
    with open(path, "w") as fh:
        for r in results:
            fh.write(json.dumps(r) + "\n")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
