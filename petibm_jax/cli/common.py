"""Shared CLI argument handling.

Mirrors the reference's PETSc-style flags (-directory, -config, -mesh,
-flow, -parameters, -bodies, -output, -logs; parser.cpp:175-237); both
single-dash and double-dash spellings are accepted.
"""

from __future__ import annotations

import argparse

from ..config import load_config


def make_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    for name in ("directory", "config", "mesh", "flow", "parameters",
                 "bodies", "probes", "output", "logs"):
        ap.add_argument(f"-{name}", f"--{name}", dest=name, default=None)
    ap.add_argument("--profile-stages", dest="profile_stages", type=int,
                    default=0, metavar="STEPS",
                    help="after the run, time each solver phase over STEPS "
                         "steps and write logs/stages-<n>.txt (the "
                         "reference's PETSc log-stage dump)")
    return ap


def maybe_profile(solver, args) -> None:
    """Run the per-phase stage profiler when --profile-stages was given."""
    if getattr(args, "profile_stages", 0):
        result = solver.profile_stages(steps=args.profile_stages)
        width = max(len(k) for k in result)
        for name, ms in result.items():
            print(f"  {name:>{width}s}: {ms:8.3f} ms")


def run_app(solver_cls, description: str, argv=None):
    """The body every solver CLI shares (reference: each application's
    main.cpp): parse the flags, build the solver, run it to the end,
    write the logs; returns the finished solver."""
    args = make_parser(description).parse_args(argv)
    solver = solver_cls(config_from_args(args))
    print(solver.mesh.info())
    bodies = getattr(solver, "bodies", None)
    if bodies is not None:
        print(f"bodies: {bodies.n_bodies} ({bodies.n_pts} points)")
    solver.run(progress=True)
    maybe_profile(solver, args)
    solver.close()
    print(solver.timers.report())
    return solver


def config_from_args(args) -> dict:
    return load_config(
        directory=args.directory, config=args.config, mesh=args.mesh,
        flow=args.flow, parameters=args.parameters, bodies=args.bodies,
        probes=args.probes, output=args.output, logs=args.logs)
