"""petibm-vorticity equivalent: compute vorticity for saved snapshots and
append to the HDF5 files (reference: applications/vorticity/main.cpp)."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np

from ..boundary import BoundarySet
from ..io.hdf5 import require_h5py
from ..io.vorticity import compute_vorticity, vorticity_meshes
from ..mesh import StaggeredMesh
from .common import config_from_args, make_parser

DIR_NAMES = ("x", "y", "z")


def main(argv=None) -> int:
    ap = make_parser("Compute vorticity for saved solution snapshots")
    ap.add_argument("-bg", "--bg", type=int, default=None)
    ap.add_argument("-ed", "--ed", type=int, default=None)
    ap.add_argument("-step", "--step", type=int, default=None)
    args = ap.parse_args(argv)
    h5py = require_h5py()
    config = config_from_args(args)
    mesh = StaggeredMesh(config)
    bcset = BoundarySet(mesh, config)
    out = config["output"]

    # append vorticity grids to grid.h5 (main.cpp:98-108)
    wmesh = vorticity_meshes(mesh)
    with h5py.File(os.path.join(out, "grid.h5"), "a") as fh:
        for name, coords in wmesh.items():
            if name in fh:
                del fh[name]
            g = fh.create_group(name)
            for d, c in enumerate(coords):
                g.create_dataset(DIR_NAMES[d], data=np.asarray(c, np.float64))

    params = config.get("parameters", {})
    bg = args.bg if args.bg is not None else int(params.get("startStep", 0))
    ed = args.ed if args.ed is not None else bg + int(params.get("nt", 0))
    step = args.step if args.step is not None else int(params.get("nsave", 1))

    names = [("u", "v", "w")[c] for c in range(mesh.dim)]
    for ite in range(bg, ed + 1, step):
        path = os.path.join(out, f"{ite:07d}.h5")
        if not os.path.isfile(path):
            print(f"skip missing {path}")
            continue
        with h5py.File(path, "r") as fh:
            q = {n: jnp.asarray(np.asarray(fh[n])) for n in names}
        bcstate = bcset.init_state(q)
        w = compute_vorticity(mesh, bcset, q, bcstate)
        with h5py.File(path, "a") as fh:
            for name, arr in w.items():
                if name in fh:
                    del fh[name]
                fh.create_dataset(name, data=np.asarray(arr, np.float64))
        print(f"[time step {ite}] wrote {', '.join(w)} to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
