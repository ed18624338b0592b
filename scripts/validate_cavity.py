#!/usr/bin/env python
"""Validate a lid-driven-cavity run against Ghia et al. (1982).

Reads the final snapshot of a case directory, interpolates u along the
vertical centerline (x=0.5) and v along the horizontal centerline (y=0.5),
and compares with the tabulated values of

  Ghia, Ghia & Shin (1982), "High-Re solutions for incompressible flow
  using the Navier-Stokes equations and a multigrid method", JCP 48(3),
  tables I & II (the same validation target the reference cites,
  reference: doc/markdowns/examples2d.md:29).

Usage: python validate_cavity.py -directory <case> [--re 100] [--step N]
Exits nonzero if the RMS deviation exceeds --tol (default 0.03 — the
discretization error of a 32x32 grid; finer grids land well below).
"""

import argparse
import glob
import os
import sys

import numpy as np

# Ghia et al. (1982): u on the vertical centerline through the geometric
# center, columns: y, Re=100, Re=1000, Re=3200, Re=5000 (tables I).
GHIA_U = np.array([
    [0.0000, 0.00000, 0.00000, 0.00000, 0.00000],
    [0.0547, -0.03717, -0.18109, -0.32407, -0.41165],
    [0.0625, -0.04192, -0.20196, -0.35344, -0.42901],
    [0.0703, -0.04775, -0.22220, -0.37827, -0.43643],
    [0.1016, -0.06434, -0.29730, -0.41933, -0.40435],
    [0.1719, -0.10150, -0.38289, -0.34323, -0.33050],
    [0.2813, -0.15662, -0.27805, -0.24427, -0.22855],
    [0.4531, -0.21090, -0.10648, -0.08664, -0.07404],
    [0.5000, -0.20581, -0.06080, -0.04272, -0.03039],
    [0.6172, -0.13641, 0.05702, 0.07156, 0.08183],
    [0.7344, 0.00332, 0.18719, 0.19791, 0.20087],
    [0.8516, 0.23151, 0.33304, 0.34682, 0.33556],
    [0.9531, 0.68717, 0.46604, 0.46101, 0.46036],
    [0.9609, 0.73722, 0.51117, 0.46547, 0.45992],
    [0.9688, 0.78871, 0.57492, 0.48296, 0.46120],
    [0.9766, 0.84123, 0.65928, 0.53236, 0.48223],
    [1.0000, 1.00000, 1.00000, 1.00000, 1.00000],
])

# Ghia et al. (1982): v on the horizontal centerline (tables II).
GHIA_V = np.array([
    [0.0000, 0.00000, 0.00000, 0.00000, 0.00000],
    [0.0625, 0.09233, 0.27485, 0.39560, 0.42447],
    [0.0703, 0.10091, 0.29012, 0.40917, 0.43329],
    [0.0781, 0.10890, 0.30353, 0.41906, 0.43648],
    [0.0938, 0.12317, 0.32627, 0.42768, 0.42951],
    [0.1563, 0.16077, 0.37095, 0.37119, 0.35368],
    [0.2266, 0.17507, 0.33075, 0.29030, 0.28066],
    [0.2344, 0.17527, 0.32235, 0.28188, 0.27280],
    [0.5000, 0.05454, 0.02526, 0.00999, 0.00945],
    [0.8047, -0.24533, -0.31966, -0.31184, -0.30018],
    [0.8594, -0.22445, -0.42665, -0.37401, -0.36214],
    [0.9063, -0.16914, -0.51550, -0.44307, -0.41442],
    [0.9453, -0.10313, -0.39188, -0.54053, -0.52876],
    [0.9531, -0.08864, -0.33714, -0.52357, -0.55408],
    [0.9609, -0.07391, -0.27669, -0.47425, -0.55069],
    [0.9688, -0.05906, -0.21388, -0.39017, -0.49774],
    [1.0000, 0.00000, 0.00000, 0.00000, 0.00000],
])

RE_COL = {100: 1, 1000: 2, 3200: 3, 5000: 4}


def interp_line(coords, vals, target):
    """Linear interpolation of a gridline of profiles at one coordinate."""
    i = int(np.searchsorted(coords, target)) - 1
    i = min(max(i, 0), len(coords) - 2)
    w = (target - coords[i]) / (coords[i + 1] - coords[i])
    return (1 - w) * vals[i] + w * vals[i + 1]


def main() -> int:
    import h5py  # reads saved snapshots; the Ghia tables above need none
    ap = argparse.ArgumentParser()
    ap.add_argument("-directory", default=".")
    ap.add_argument("--re", type=int, default=100, choices=sorted(RE_COL))
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--tol", type=float, default=0.03)
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args()

    out = os.path.join(args.directory, "output")
    if args.step is None:
        snaps = sorted(glob.glob(os.path.join(out, "*.h5")))
        snaps = [s for s in snaps if os.path.basename(s)[0].isdigit()]
        path = snaps[-1]
    else:
        path = os.path.join(out, f"{args.step:07d}.h5")
    with h5py.File(os.path.join(out, "grid.h5")) as g:
        xu, yu = g["u/x"][:], g["u/y"][:]
        xv, yv = g["v/x"][:], g["v/y"][:]
    with h5py.File(path) as f:
        u, v = f["u"][:], f["v"][:]

    col = RE_COL[args.re]
    # u(y) on the vertical centerline
    u_mid = np.array([interp_line(xu, u[j, :], 0.5) for j in range(u.shape[0])])
    u_ref = GHIA_U[:, col]
    u_sim = np.interp(GHIA_U[:, 0], yu, u_mid, left=0.0)
    u_sim[GHIA_U[:, 0] >= 1.0] = u_ref[GHIA_U[:, 0] >= 1.0]  # lid itself
    u_sim[GHIA_U[:, 0] <= 0.0] = 0.0
    # v(x) on the horizontal centerline
    v_mid = np.array([interp_line(yv, v[:, i], 0.5) for i in range(v.shape[1])])
    v_ref = GHIA_V[:, col]
    v_sim = np.interp(GHIA_V[:, 0], xv, v_mid, left=0.0)
    v_sim[(GHIA_V[:, 0] <= 0.0) | (GHIA_V[:, 0] >= 1.0)] = 0.0

    rms_u = float(np.sqrt(np.mean((u_sim - u_ref) ** 2)))
    rms_v = float(np.sqrt(np.mean((v_sim - v_ref) ** 2)))
    print(f"cavity Re={args.re} vs Ghia et al. (1982):")
    print(f"  u centerline RMS deviation: {rms_u:.5f}")
    print(f"  v centerline RMS deviation: {rms_v:.5f}")

    if args.plot:
        from matplotlib import pyplot as plt

        fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 4))
        a1.plot(u_mid, yu, "-", label="petibm-jax")
        a1.plot(u_ref, GHIA_U[:, 0], "o", label="Ghia et al. 1982")
        a1.set(xlabel="u", ylabel="y")
        a1.legend()
        a2.plot(xv, v_mid, "-", label="petibm-jax")
        a2.plot(GHIA_V[:, 0], v_ref, "o", label="Ghia et al. 1982")
        a2.set(xlabel="x", ylabel="v")
        fig.tight_layout()
        fig.savefig(os.path.join(args.directory, "cavity_validation.png"), dpi=120)
        print("  wrote cavity_validation.png")

    ok = rms_u <= args.tol and rms_v <= args.tol
    print("  PASS" if ok else f"  FAIL (tol {args.tol})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
