"""petibm-decoupledibpm equivalent
(reference: applications/decoupledibpm/main.cpp)."""

from __future__ import annotations

import sys

from ..solvers.decoupledibpm import DecoupledIBPMSolver
from .common import run_app


def run(argv=None):
    """Run the application; returns the finished solver."""
    return run_app(DecoupledIBPMSolver,
                   "decoupled IBPM solver (Li et al. 2016)", argv)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
