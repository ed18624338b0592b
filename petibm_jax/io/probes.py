"""Probes: volume sub-field monitors and interpolated point monitors.

Reference (src/misc/probes.cpp, include/petibm/probes.h:30-382):
  - Gating: monitor when ``n % n_monitor == 0`` and ``t_start <= t <= t_end``
    (probes.cpp:114-148).
  - ProbeVolume: a box selects a sub-mesh of one field's grid
    (lower/upper_bound with atol, :267-310); values written per monitor
    call to ASCII ("t = <t>" + one value per line) or HDF5 (group
    "mesh" with x/y/z + natural-index "IS", group "<field>" with one
    dataset per time, optional time-averaging over n_sum steps with a
    "count" attribute, :489-573).
  - ProbePoint: bi/tri-linear interpolation at a location, ASCII lines
    "t<tab>value" (:607-687; lininterp.cpp:94-209).
"""

from __future__ import annotations

import os

import numpy as np

from ..mesh import StaggeredMesh
from ..types import Field, STR2FIELD
from .hdf5 import require_h5py

VEL_NAMES = ("u", "v", "w")
DIR_NAMES = ("x", "y", "z")


def create_probe(node: dict, mesh: StaggeredMesh, bcset=None):
    """Factory (reference: probes.cpp:23-51)."""
    ptype = str(node.get("type", "VOLUME")).upper()
    if ptype == "VOLUME":
        return ProbeVolume(node, mesh)
    if ptype == "POINT":
        return ProbePoint(node, mesh, bcset)
    raise ValueError(f"unknown probe type {ptype}; accepted: VOLUME, POINT")


class ProbeBase:
    def __init__(self, node: dict, mesh: StaggeredMesh):
        self.mesh = mesh
        self.name = node.get("name", "unnamed")
        self.field = int(STR2FIELD[node["field"]])
        self.path = node["path"]
        self.n_monitor = int(node.get("n_monitor", 1))
        self.t_start = float(node.get("t_start", 0.0))
        self.t_end = float(node.get("t_end", 1e12))

    def _field_array(self, fields: dict) -> np.ndarray:
        name = VEL_NAMES[self.field] if self.field < self.mesh.dim else "p"
        return np.asarray(fields[name])

    def monitor(self, fields: dict, n: int, t: float) -> None:
        if n % self.n_monitor == 0 and self.t_start <= t <= self.t_end:
            self.monitor_vec(self._field_array(fields), n, t)

    def monitor_vec(self, arr: np.ndarray, n: int, t: float) -> None:
        raise NotImplementedError


class ProbeVolume(ProbeBase):
    def __init__(self, node: dict, mesh: StaggeredMesh):
        super().__init__(node, mesh)
        self.viewer = node.get("viewer", "ascii")
        self.atol = float(node.get("atol", 1e-6))
        self.n_sum = int(node.get("n_sum", 0))
        self._accum = None
        self._count = 0

        box = node["box"]
        self.start = [0] * mesh.dim
        self.npts = [1] * mesh.dim
        f = Field(self.field)
        for d in range(mesh.dim):
            line = mesh.coord(f, d)
            lo, hi = (float(v) for v in box[DIR_NAMES[d]])
            # lower/upper_bound with tolerance (probes.cpp:267-310 getInfo)
            start = int(np.searchsorted(line, lo - self.atol, side="left"))
            stop = int(np.searchsorted(line, hi + self.atol, side="right"))
            self.start[d] = start
            self.npts[d] = stop - start
        self.sub_coords = [mesh.coord(f, d)[self.start[d]:self.start[d] + self.npts[d]]
                           for d in range(mesh.dim)]
        # natural (x-fastest) flat indices of the box points
        grids = np.meshgrid(*[np.arange(self.start[d], self.start[d] + self.npts[d])
                              for d in range(mesh.dim)], indexing="ij")
        ns = [mesh.n(f, d) for d in range(mesh.dim)]
        flat = np.zeros_like(grids[0])
        stride = 1
        for d in range(mesh.dim):
            flat = flat + grids[d] * stride
            stride *= ns[d]
        # transpose to (z, y, x) iteration order so indices are ascending
        self.natural_is = np.sort(flat.ravel())
        self._write_grid()

    def _slices(self):
        return tuple(slice(self.start[d], self.start[d] + self.npts[d])
                     for d in reversed(range(self.mesh.dim)))

    def _write_grid(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if self.viewer == "hdf5":
            with require_h5py().File(self.path, "w") as fh:
                g = fh.create_group("mesh")
                for d in range(self.mesh.dim):
                    g.create_dataset(DIR_NAMES[d], data=self.sub_coords[d])
                g.create_dataset("IS", data=self.natural_is.astype(np.int64))
        else:
            with open(self.path, "w") as fh:
                for d in range(self.mesh.dim):
                    fh.write(DIR_NAMES[d] + "\n")
                    for v in self.sub_coords[d]:
                        fh.write(f"{v:18.16e}\n")
                fh.write("IS\n")
                for v in self.natural_is:
                    fh.write(f"{v}\n")

    def monitor_vec(self, arr: np.ndarray, n: int, t: float) -> None:
        sub = arr[self._slices()]
        if self.n_sum != 0:
            # time accumulation / averaging (probes.cpp:489-526)
            if self._accum is None:
                self._accum = np.zeros_like(sub, dtype=np.float64)
            self._accum += sub
            self._count += 1
            if self._count % self.n_sum == 0:
                self._write(self._accum / self._count, t, self._count)
                self._accum[:] = 0.0
                self._count = 0
        else:
            self._write(sub, t, 0)

    def _write(self, data: np.ndarray, t: float, count: int) -> None:
        if self.viewer == "hdf5":
            with require_h5py().File(self.path, "a") as fh:
                grp = fh.require_group(
                    VEL_NAMES[self.field] if self.field < self.mesh.dim else "p")
                name = f"{t:.6f}"
                if name in grp:
                    del grp[name]
                ds = grp.create_dataset(name, data=np.asarray(data, np.float64))
                if count:
                    ds.attrs["count"] = count
        else:
            with open(self.path, "a") as fh:
                fh.write(f"\nt = {t:e}\n")
                if count:
                    fh.write(f"count = {count}\n")
                for v in np.asarray(data, np.float64).ravel():
                    fh.write(f"{v:18.16e}\n")


class ProbePoint(ProbeBase):
    def __init__(self, node: dict, mesh: StaggeredMesh, bcset=None):
        super().__init__(node, mesh)
        self.bcset = bcset
        self.loc = [float(v) for v in node["loc"]]
        f = Field(self.field)
        # bottom-left ghosted-line cell and linear weights per direction
        # (lininterp.cpp:94-209)
        self.base_idx = []
        self.weights = []
        for d in range(mesh.dim):
            line = mesh.coord_ghosted(f, d)
            i = int(np.searchsorted(line, self.loc[d], side="right")) - 1
            i = min(max(i, 0), len(line) - 2)
            w = (self.loc[d] - line[i]) / (line[i + 1] - line[i])
            self.base_idx.append(i)  # index into the ghosted array
            self.weights.append(w)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fh = open(self.path, "w")

    def monitor(self, fields: dict, n: int, t: float) -> None:
        if not (n % self.n_monitor == 0 and self.t_start <= t <= self.t_end):
            return
        arr = self._field_array(fields)
        # ghost-extend so near-boundary interpolation sees BC values
        ext = self._extended(fields, arr)
        val = 0.0
        for corner in np.ndindex(*([2] * self.mesh.dim)):
            w = 1.0
            idx = [0] * self.mesh.dim
            for d in range(self.mesh.dim):
                bit = corner[self.mesh.dim - 1 - d]  # corner in (z,y,x) order
                idx[self.mesh.axis_of(d)] = self.base_idx[d] + (
                    corner[self.mesh.dim - 1 - d])
                w *= self.weights[d] if bit else (1.0 - self.weights[d])
            val += w * ext[tuple(idx)]
        self._fh.write(f"{t:10.8e}\t{val:10.8e}\n")
        self._fh.flush()

    def _extended(self, fields: dict, arr: np.ndarray) -> np.ndarray:
        if self.field < self.mesh.dim and self.bcset is not None:
            bcstate = fields.get("_bcstate")
            if bcstate is not None:
                import jax.numpy as jnp

                return np.asarray(self.bcset.extend(
                    jnp.asarray(arr), self.field, bcstate))
        # pressure (or missing bc state): edge padding
        return np.pad(arr, 1, mode="edge")

    def close(self):
        if not self._fh.closed:
            self._fh.close()
