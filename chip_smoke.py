"""Bring-up check of the solver on NVIDIA GPUs, through its command-line
applications.

    python chip_smoke.py          # one GPU, every phase below
    python chip_smoke.py --four   # four GPUs: only the sharded phase

Phases of the default run (each prints its wall time):

  device     JAX must see a GPU (no CPU fallback); prints its kind, the
             device count and ``nvidia-smi``'s name and power limit.
  main       the decoupled-IBPM application on the 450x450 stretched
             cylinder at Re=200 (examples/decoupledibpm/cylinder2dRe200,
             float32, atol 1e-6), 2000 steps in two 1000-step dispatches;
             prints the steady ms/step of the second dispatch.
  cpu_match  the first 20 steps of the same case on the GPU and on the host
             CPU (a child process that hides the GPU), compared: forces,
             velocity and pressure within TOLERANCES.
  coupled    the coupled-IBPM application on the 450x450 Re=550 cylinder
             (Schur-complement direct solve), a few steps.
  sphere     the decoupled-IBPM application on the 160x130x130 sphere at
             Re=300, a few steps (3D stencils and transforms).
  mg         the 450x450 cylinder with ``fdm: false``: multigrid-
             preconditioned CG with its line smoother, a few steps.

``--four`` runs the 450x450 cylinder and the sphere decomposed over four
GPUs (``sharding: {nDevices: 4}``, a 2x2 mesh) and the same steps on one
GPU, and compares them.

Every run goes through the application's ``run`` (the CLI's own argument
parsing, solver construction and time loop) on a scratch copy of the
example with field output off (``nsave: 0``).  A run's divergence policy
is ``abort``, so a step in which any solver did not converge ends it with
an error; the checks then require finite fields and one finite log line
per step.  A failing phase fails the run.  The last line of standard
output is one JSON object, ``{"ok": ..., "device": {...}}``; the exit code
is 0 only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(ROOT, "examples")

#: GPU-versus-CPU agreement after 20 steps, each a maximum difference
#: relative to the CPU run's largest magnitude.  The solves stop at an
#: absolute residual of 1e-6 and run in float32, where the GPU takes the
#: velocity and delta-operator products in TF32 and sums in another order,
#: so the two runs agree to about the solver tolerance, not to rounding.
TOLERANCES = {"force": 1e-4, "velocity": 1e-5, "pressure": 1e-4}

#: the matmuls of a float32 run and the precision each asks for; on a GPU
#: with tensor cores a float32 product at "default" runs in TF32
PRODUCT_PRECISION = (
    ("FDM pressure transforms (linalg/fdm.py FastDiagPoisson)",
     "highest: full float32"),
    ("FDM velocity transforms (FastDiagHelmholtz)",
     "default: TF32, absorbed by the true-residual refinement"),
    ("delta spread/interpolate einsums (ibm/interp.py)",
     "highest: full float32"),
    ("dense EBNH and Schur inverse matvecs (decoupledibpm.py, ibpm.py)",
     "highest: full float32"),
)


# ----------------------------------------------------------------------
# cases and runs
def prepare_case(src: str, dst: str, **params) -> str:
    """Copy the example directory ``src`` (without its output) to ``dst``
    and update its ``parameters`` node; field output is off."""
    import yaml

    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("output"))
    path = os.path.join(dst, "config.yaml")
    with open(path) as fh:
        cfg = yaml.safe_load(fh)
    cfg.setdefault("parameters", {}).update(
        {"nsave": 0, "nrestart": 0, "divergence": "abort", **params})
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return dst


def run_case(app: str, directory: str):
    """Run a solver application on a case directory; returns the solver."""
    import importlib

    cli = importlib.import_module(f"petibm_jax.cli.{app}")
    return cli.run(["-directory", directory])


def collect(solver) -> dict:
    """Fields, per-step solver log and per-step forces of a finished run,
    as NumPy arrays."""
    import numpy as np

    out = {f"q_{k}": np.asarray(v) for k, v in solver.state["q"].items()}
    out["p"] = np.asarray(solver.state["p"])
    out["iterations"] = np.atleast_2d(np.loadtxt(solver.iter_log_path))
    forces = os.path.join(solver.output_dir, f"forces-{solver.nstart}.txt")
    if os.path.isfile(forces):
        out["forces"] = np.atleast_2d(np.loadtxt(forces))
    return out


def check_run(solver, nt: int) -> dict:
    """A finished run's own checks; returns its collected arrays."""
    import numpy as np

    if solver.ite != solver.nstart + nt:
        raise AssertionError(f"ran to step {solver.ite}, expected {nt}")
    data = collect(solver)
    for key, arr in data.items():
        if not np.all(np.isfinite(arr)):
            raise AssertionError(f"non-finite values in {key}")
    for key in ("iterations", "forces"):
        if key in data and data[key].shape[0] != nt:
            raise AssertionError(
                f"{key} log has {data[key].shape[0]} lines, expected {nt}")
    if hasattr(solver, "bodies") and "forces" not in data:
        raise AssertionError("no forces log written")
    return data


def compare(ref: dict, got: dict) -> dict:
    """Largest differences of ``got`` from ``ref`` relative to the largest
    magnitude in ``ref``: forces (every logged step), velocity components
    and pressure (final state).  ``ok`` holds them to TOLERANCES."""
    import numpy as np

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30))

    out = {"velocity": max(rel(ref[k], got[k]) for k in ref
                           if k.startswith("q_")),
           "pressure": rel(ref["p"], got["p"])}
    if "forces" in ref:
        out["force"] = rel(ref["forces"][:, 1:], got["forces"][:, 1:])
    out["ok"] = all(out[k] <= TOLERANCES[k] for k in TOLERANCES if k in out)
    return out


def iterations_summary(data: dict) -> dict:
    """Mean refinement/Krylov passes per step of each solver in the log
    (columns: step, then iterations and residual per solver)."""
    it = data["iterations"]
    names = ("v_iters", "p_iters", "f_iters")
    return {names[k]: float(it[:, 1 + 2 * k].mean())
            for k in range((it.shape[1] - 1) // 2)}


def cpu_reference(directory: str, out_path: str) -> int:
    """Child-process mode: run the case on the host CPU, save arrays."""
    import numpy as np

    solver = run_case("decoupledibpm", directory)
    np.savez(out_path, **collect(solver))
    return 0


def run_on_cpu(directory: str) -> dict:
    """The case run by a child process that cannot see the GPU."""
    import numpy as np

    out = os.path.join(directory, "cpu_reference.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--cpu-reference", directory, out],
                   env=env, check=True, timeout=900)
    with np.load(out) as data:
        return dict(data)


# ----------------------------------------------------------------------
# phases
def phase_main(work: str) -> dict:
    case = prepare_case(
        os.path.join(EXAMPLES, "decoupledibpm", "cylinder2dRe200"),
        os.path.join(work, "main"), nt=2000, stepsPerDispatch=1000,
        dtype="float32")
    solver = run_case("decoupledibpm", case)
    data = check_run(solver, 2000)
    first, last, ms = solver.step_rates[-1]
    if (first, last) != (1001, 2000):
        raise AssertionError(f"unexpected dispatches {solver.step_rates}")
    return {"ms_per_step_steps_1001_2000": ms,
            "ms_per_step_steps_1_1000_with_compile": solver.step_rates[0][2],
            **iterations_summary(data)}


def phase_cpu_match(work: str) -> dict:
    src = os.path.join(EXAMPLES, "decoupledibpm", "cylinder2dRe200")
    params = dict(nt=20, stepsPerDispatch=1, dtype="float32")
    gpu = check_run(run_case("decoupledibpm", prepare_case(
        src, os.path.join(work, "match_gpu"), **params)), 20)
    cpu = run_on_cpu(prepare_case(src, os.path.join(work, "match_cpu"),
                                  **params))
    result = compare(cpu, gpu)
    result["iterations_gpu"] = iterations_summary(gpu)
    result["iterations_cpu"] = iterations_summary(cpu)
    if not result["ok"]:
        raise AssertionError(f"GPU and CPU runs differ: {result}")
    return result


def _short_run(work: str, name: str, app: str, example: str, k: int,
               **params) -> dict:
    """Two dispatches of k steps: the first compiles, the second gives
    the steady ms/step."""
    case = prepare_case(os.path.join(EXAMPLES, example),
                        os.path.join(work, name), nt=2 * k,
                        stepsPerDispatch=k, dtype="float32", **params)
    solver = run_case(app, case)
    data = check_run(solver, 2 * k)
    return {"ms_per_step_first_dispatch_with_compile":
            solver.step_rates[0][2],
            "ms_per_step_second_dispatch": solver.step_rates[-1][2],
            **iterations_summary(data)}


def phase_coupled(work: str) -> dict:
    return _short_run(work, "coupled", "ibpm", "ibpm/cylinder2dRe550", 20)


def phase_sphere(work: str) -> dict:
    return _short_run(work, "sphere", "decoupledibpm",
                      "decoupledibpm/sphere3dRe300", 10)


def phase_mg(work: str) -> dict:
    return _short_run(work, "mg", "decoupledibpm",
                      "decoupledibpm/cylinder2dRe200", 10, fdm=False)


#: the --four phase's cases: (name, example directory, steps)
FOUR_CASES = (
    ("cylinder", os.path.join(EXAMPLES, "decoupledibpm", "cylinder2dRe200"),
     20),
    ("sphere", os.path.join(EXAMPLES, "decoupledibpm", "sphere3dRe300"),
     10),
)


def phase_four(work: str) -> dict:
    """Each case on four GPUs (sharded) and on one, compared."""
    import jax

    if len(jax.devices()) < 4:
        raise AssertionError(f"--four needs 4 GPUs, found {jax.devices()}")
    out = {}
    for name, src, nt in FOUR_CASES:
        params = dict(nt=nt, stepsPerDispatch=nt, dtype="float32")
        one = check_run(run_case("decoupledibpm", prepare_case(
            src, os.path.join(work, f"{name}_1"), **params)), nt)
        solver = run_case("decoupledibpm", prepare_case(
            src, os.path.join(work, f"{name}_4"),
            sharding={"nDevices": 4}, **params))
        four = check_run(solver, nt)
        spans = {len(leaf.sharding.device_set)
                 for leaf in jax.tree_util.tree_leaves(solver.state["q"])}
        if spans != {4}:
            raise AssertionError(f"velocity fields span {spans} devices")
        result = compare(one, four)
        result["peak_bytes_per_device"] = [
            (d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in jax.devices()]
        if not result["ok"]:
            raise AssertionError(f"{name}: 4 GPUs and 1 differ: {result}")
        out[name] = result
    return out


# ----------------------------------------------------------------------
def _device_info() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def _finish(ok: bool, device: dict, error: str | None = None) -> int:
    line = {"ok": ok, "device": device}
    if error:
        line["error"] = error
    print(json.dumps(line), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phase")
    ap.add_argument("--cpu-reference", nargs=2, metavar=("DIR", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_reference:
        sys.path.insert(0, ROOT)
        return cpu_reference(*args.cpu_reference)

    t0 = time.perf_counter()
    device = _device_info()
    print(f"[device] JAX devices: {device['count']} x {device['kind']} "
          f"({device['platform']})", flush=True)
    if device["platform"] != "gpu":
        return _finish(False, device, "no GPU: JAX found only "
                       f"{device['platform']} devices")
    try:
        gpu = _nvidia_smi()
    except (OSError, subprocess.SubprocessError) as exc:
        return _finish(False, device, f"nvidia-smi failed: {exc}")
    print("[device] nvidia-smi --query-gpu=name,power.limit:", flush=True)
    print(gpu, flush=True)
    sys.path.insert(0, ROOT)
    try:
        import petibm_jax  # noqa: F401
    except ImportError as exc:
        return _finish(False, device, f"the solver package is missing: {exc}")
    print(f"[device] done in {time.perf_counter() - t0:.1f} s", flush=True)
    for product, precision in PRODUCT_PRECISION:
        print(f"[precision] {product}: {precision}")

    phases = ([("four", phase_four)] if args.four else
              [("main", phase_main), ("cpu_match", phase_cpu_match),
               ("coupled", phase_coupled), ("sphere", phase_sphere),
               ("mg", phase_mg)])
    failed = []
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for name, fn in phases:
            t = time.perf_counter()
            try:
                result = fn(work)
            except Exception:  # report the phase, run the others
                traceback.print_exc()
                failed.append(name)
                result = "FAILED"
            print(f"[{name}] {json.dumps(result)}", flush=True)
            print(f"[{name}] wall {time.perf_counter() - t:.1f} s "
                  f"on {gpu}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[total] wall {time.perf_counter() - t0:.1f} s", flush=True)
    return _finish(not failed, device,
                   f"failed phases: {failed}" if failed else None)


if __name__ == "__main__":
    sys.exit(main())
