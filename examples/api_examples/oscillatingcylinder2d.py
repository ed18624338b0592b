"""Library-API example: user-defined rigid-body kinematics by subclassing.

Mirrors the reference's oscillating-cylinder API example
(examples/api_examples/oscillatingcylinder2dRe100_GPU/oscillatingcylinder.cpp:
12-111), where users subclass RigidKinematicsSolver and override the
coordinate/velocity virtuals.  Here the overrides are pure functions of the
traced time, so the motion runs inside the jitted step with zero
recompilation — no per-step operator re-assembly as in the reference.

Run:  PYTHONPATH=<repo> python examples/api_examples/oscillatingcylinder2d.py
"""

import math
import os
import tempfile

import jax.numpy as jnp
import numpy as np

from petibm_jax.solvers.rigidkinematics import RigidKinematicsSolver

# in-line cylinder oscillation, Re = U_m D / nu = 100, KC = U_m / (f D) = 5
F_OSC = 0.2          # oscillation frequency
D = 1.0              # cylinder diameter
KC = 5.0
AM = D * KC / (2.0 * math.pi)       # displacement amplitude
UM = 2.0 * math.pi * F_OSC * AM     # velocity amplitude


class OscillatingCylinderSolver(RigidKinematicsSolver):
    """Override the kinematics virtuals instead of using the built-in
    ``kinematics:`` config node (setCoordinatesBodies/setVelocityBodies)."""

    def set_coordinates(self, t):
        dx = -AM * jnp.sin(2.0 * math.pi * F_OSC * t)
        return self.coords0 + jnp.stack(
            [dx, jnp.zeros_like(dx)])

    def set_velocity(self, t):
        ux = -UM * jnp.cos(2.0 * math.pi * F_OSC * t)
        vel = jnp.stack([ux, jnp.zeros_like(ux)])
        return jnp.broadcast_to(vel, (self.bodies.n_pts, 2))


def make_case(tmpdir: str, n_cells: int = 60, nt: int = 40) -> dict:
    # cylinder body file
    npts = 50
    body = os.path.join(tmpdir, "circle.body")
    with open(body, "w") as fh:
        fh.write(f"{npts}\n")
        for k in range(npts):
            th = 2 * math.pi * k / npts
            fh.write(f"{0.5 * D * math.cos(th):.10e}\t"
                     f"{0.5 * D * math.sin(th):.10e}\n")
    return {
        "directory": tmpdir,
        "output": os.path.join(tmpdir, "output"),
        "logs": os.path.join(tmpdir, "output", "logs"),
        "mesh": [
            {"direction": d, "start": -5.0,
             "subDomains": [{"end": 5.0, "cells": n_cells, "stretchRatio": 1.0}]}
            for d in ("x", "y")
        ],
        "flow": {
            "nu": UM * D / 100.0,
            "initialVelocity": [0.0, 0.0],
            "boundaryConditions": [
                {"location": loc, "u": ["DIRICHLET", 0.0],
                 "v": ["DIRICHLET", 0.0]}
                for loc in ("xMinus", "xPlus", "yMinus", "yPlus")
            ],
        },
        "parameters": {
            "dt": 0.01, "nt": nt, "nsave": nt, "nrestart": nt,
            "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
            "velocitySolver": {"type": "CPU", "atol": 1e-6},
            "poissonSolver": {"type": "CPU", "atol": 1e-6},
            "forcesSolver": {"type": "CPU", "atol": 1e-6},
        },
        "bodies": [{"type": "points", "file": body}],
    }


def main() -> None:
    tmpdir = tempfile.mkdtemp(prefix="osc_cyl_")
    solver = OscillatingCylinderSolver(make_case(tmpdir))
    solver.run()
    solver.close()
    forces = np.loadtxt(os.path.join(tmpdir, "output", "forces-0.txt"))
    print(f"ran {forces.shape[0]} steps; final t={forces[-1, 0]:.2f} "
          f"fx={forces[-1, 1]:+.4f} fy={forces[-1, 2]:+.4f}")
    print(f"outputs in {tmpdir}/output")


if __name__ == "__main__":
    main()
