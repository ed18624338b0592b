"""Prescribed-kinematics moving-body solver CLI.

The reference ships RigidKinematicsSolver as a header-only extension point
(users write a main; applications/rigidkinematics/).  The built-in
``kinematics:`` config node makes the common prescribed motions runnable
directly; custom motion = subclass RigidKinematicsSolver in user code.
"""

from __future__ import annotations

import sys

from ..solvers.rigidkinematics import RigidKinematicsSolver
from .common import run_app


def run(argv=None):
    """Run the application; returns the finished solver."""
    return run_app(RigidKinematicsSolver,
                   "decoupled IBPM with prescribed body kinematics", argv)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
