"""Prescribed-kinematics moving rigid bodies on the decoupled IBPM.

JAX re-design of the reference's RigidKinematicsSolver extension
point (reference: applications/rigidkinematics/rigidkinematics.{h,cpp}).
The reference destroys and re-assembles E/H/BNH/EBNH and re-factorizes the
force solver every step (moveBodies, rigidkinematics.cpp:119-140) — the
performance hazard SURVEY.md §3.2 flags.  Here body coordinates are a pure
function of time evaluated *inside* the jitted step: the delta windows
(gather/scatter indices + weights) are traced arrays with static shapes, so
moving bodies cost one window recomputation per step and zero recompiles.

Users subclass and override ``set_coordinates`` / ``set_velocity``
(the reference's setCoordinatesBodies/setVelocityBodies virtuals); the
built-in ``kinematics:`` config node covers the shipped oscillating-cylinder
motion (reference: examples/api_examples/oscillatingcylinder2dRe100_GPU/
oscillatingcylinder.cpp:64-111) without any user code:

  bodies:
    - type: points
      file: circle.body
      kinematics: {type: oscillation, f: 0.2, D: 1.0, KC: 5.0, center: [0, 0]}
"""

from __future__ import annotations

import math
import os

import jax.numpy as jnp
import numpy as np

from ..ibm.body import write_lagrangian_points
from .decoupledibpm import DecoupledIBPMSolver


class RigidKinematicsSolver(DecoupledIBPMSolver):
    _moving_bodies = True  # windows recomputed inside the jitted step

    def _extra_init(self, config: dict) -> None:
        super()._extra_init(config)
        self.coords0 = jnp.asarray(self.bodies.all_coords(), self.dtype)
        self.state["t"] = jnp.asarray(self.t, self.dtype)
        self._kinematics = []
        for i, node in enumerate(config.get("bodies", [])):
            self._kinematics.append(node.get("kinematics"))

    # -- user extension points (reference: rigidkinematics.h virtuals) ----
    def set_coordinates(self, t):
        """Body-point coordinates at time t (traced); default: built-in
        kinematics per body, else stationary."""
        out = []
        for body, sl, kin in zip(self.bodies.bodies, self.bodies.slices(),
                                 self._kinematics):
            base = self.coords0[sl]
            out.append(base + self._displacement(kin, t))
        return jnp.concatenate(out, axis=0)

    def set_velocity(self, t):
        """Body-point velocities at time t (traced)."""
        out = []
        for body, sl, kin in zip(self.bodies.bodies, self.bodies.slices(),
                                 self._kinematics):
            vel = self._velocity(kin, t)
            out.append(jnp.broadcast_to(vel, (sl.stop - sl.start, self.mesh.dim)))
        return jnp.concatenate(out, axis=0)

    def _osc_params(self, kin):
        f = float(kin.get("f", 0.0))
        d = float(kin.get("D", 1.0))
        kc = float(kin.get("KC", 0.0))
        am = d * kc / (2.0 * math.pi)
        um = 2.0 * math.pi * f * am
        return f, am, um

    def _displacement(self, kin, t):
        if kin is None or kin.get("type", "static") == "static":
            return jnp.zeros(self.mesh.dim, self.dtype)
        if kin["type"] == "oscillation":
            # Xd = -Am sin(2 pi f t) in x (oscillatingcylinder.cpp:77-86)
            f, am, _ = self._osc_params(kin)
            disp = [-am * jnp.sin(2.0 * math.pi * f * t)] + [0.0] * (self.mesh.dim - 1)
            return jnp.stack([jnp.asarray(v, self.dtype) for v in disp])
        raise ValueError(f"unknown kinematics type: {kin['type']}")

    def _velocity(self, kin, t):
        if kin is None or kin.get("type", "static") == "static":
            return jnp.zeros(self.mesh.dim, self.dtype)
        if kin["type"] == "oscillation":
            # Ux = -Um cos(2 pi f t) (oscillatingcylinder.cpp:93-103)
            f, _, um = self._osc_params(kin)
            vel = [-um * jnp.cos(2.0 * math.pi * f * t)] + [0.0] * (self.mesh.dim - 1)
            return jnp.stack([jnp.asarray(v, self.dtype) for v in vel])
        raise ValueError(f"unknown kinematics type: {kin['type']}")

    # -- step wiring (moveBodies prepended, rigidkinematics.cpp:69-81) ----
    def _pre_step(self, state):
        return dict(state, t=state["t"] + self.dt)

    def _windows(self, state):
        return self.delta.windows(self.set_coordinates(state["t"]))

    def _body_velocity(self, state):
        return self.set_velocity(state["t"])

    # -- body output (writeBodies, rigidkinematics.cpp:162-183) -----------
    def io_initial_data(self) -> None:
        super().io_initial_data()
        self.state["t"] = jnp.asarray(self.t, self.dtype)
        self.write_bodies()

    def write(self) -> None:
        super().write()
        if self._due(self.nsave):
            self.write_bodies()

    def write_bodies(self) -> None:
        coords = np.asarray(self.set_coordinates(jnp.asarray(self.t, self.dtype)))
        for body, sl in zip(self.bodies.bodies, self.bodies.slices()):
            path = os.path.join(
                self.output_dir,
                f"{body.name}_{self.ite:07d}.{self.mesh.dim}D")
            write_lagrangian_points(path, coords[sl])
