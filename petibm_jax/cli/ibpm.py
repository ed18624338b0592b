"""petibm-ibpm equivalent (reference: applications/ibpm/main.cpp)."""

from __future__ import annotations

import sys

from ..solvers.ibpm import IBPMSolver
from .common import run_app


def run(argv=None):
    """Run the application; returns the finished solver."""
    return run_app(IBPMSolver,
                   "IBPM solver (Taira & Colonius 2007)", argv)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
