"""petibm-navierstokes equivalent
(reference: applications/navierstokes/main.cpp:45-78)."""

from __future__ import annotations

import sys

from ..solvers.navierstokes import NavierStokesSolver
from .common import run_app


def run(argv=None):
    """Run the application; returns the finished solver."""
    return run_app(NavierStokesSolver,
                   "Navier-Stokes projection solver", argv)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
