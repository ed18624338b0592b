"""Buffered per-step forces log shared by the IBM solvers.

forces-<start>.txt: t then per-body integrated force components
(reference: decoupledibpm.cpp:420-453, ibpm.cpp:388-423).  Forces ride
along in the step's stats stream (key "f", stacked along axis 0 when the
dispatch is chunked), stay device-resident, and flush in one batched
transfer at save points so per-step output never syncs the device.
"""

from __future__ import annotations

import os

import jax
import numpy as np


class ForcesLogMixin:
    """Requires: step stats contain "f"; self.bodies is a BodyPack."""

    _forces_log = None

    def _record_stats(self, ite0: int, stats, count: int) -> None:
        super()._record_stats(ite0, stats, count)
        if self._forces_log is None:
            self._forces_log = open(os.path.join(
                self.output_dir, f"forces-{self.nstart}.txt"), "w")
            self._forces_buffer = []
        t0 = self.t - (count - 1) * self.dt  # t of the chunk's first step
        self._forces_buffer.append((t0, stats["f"], count))

    def write(self) -> None:
        super().write()
        self.write_forces_ascii()

    def write_forces_ascii(self) -> None:
        if self._due(self.nsave) or self.finished():
            self._flush_forces()

    def _flush_forces(self) -> None:
        if not getattr(self, "_forces_buffer", None):
            return
        with self.timers.stage("integrateForces"):
            items = jax.device_get(self._forces_buffer)
        self._forces_buffer = []
        for t0, fs, count in items:
            for j in range(count):
                t = t0 + j * self.dt
                f = fs if count == 1 else fs[j]
                favg = self.bodies.avg_forces(np.asarray(f))
                cols = [f"{t:10.8e}"]
                for body_force in favg:
                    cols.extend(f"{v:10.8e}" for v in body_force)
                self._forces_log.write("\t".join(cols) + "\n")
        self._forces_log.flush()

    def close(self) -> None:
        self._flush_forces()
        super().close()
        if self._forces_log and not self._forces_log.closed:
            self._forces_log.close()
