"""Publication-style validation figures from the recorded runs.

Produces (into docs/figures/) the overlay plots the reference ships as
per-example postprocessing output (e.g.
examples/ibpm/cylinder2dRe550/scripts/plotDragCoefficient.py):

  kl_cd_overlay.png       Cd(t), impulsively-started cylinder Re=550 and
                          Re=3000 vs Koumoutsakos & Leonard (1995)
  cavity_centerlines.png  u/v centerline profiles, lid-driven cavity
                          Re=100/1000/3200/5000 vs Ghia et al. (1982)
  flatplate_aoa.png       Cd/Cl vs AoA, 3D flat plate Re=100 AR=2 vs
                          Taira et al. (2007), from the recorded
                          validation/flatplate.json sweep

Skips (with a message) any figure whose inputs are not present.  Pure
matplotlib, no device access — safe to run anywhere:

  python scripts/plot_validation.py
"""

from __future__ import annotations

import json
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
FIGDIR = os.path.join(REPO, "docs", "figures")

# simulation = solid line, published = open circles: identity is carried
# by mark type as well as hue (colorblind/print safe for 2 series)
SIM = dict(color="#2f6fde", lw=1.6, zorder=2, label="petibm-jax")
PUB = dict(color="#343a46", marker="o", ls="none", mfc="none", ms=5,
           zorder=3)

STYLE = {
    "axes.spines.top": False, "axes.spines.right": False,
    "axes.grid": True, "grid.color": "#e3e5ea", "grid.linewidth": 0.6,
    "axes.edgecolor": "#9aa0ab", "axes.labelcolor": "#343a46",
    "xtick.color": "#5b6170", "ytick.color": "#5b6170",
    "font.size": 10, "figure.dpi": 130,
}


def kl_overlay() -> bool:
    cases = []
    for re in (550, 3000):
        forces = os.path.join(REPO, "examples", "ibpm",
                              f"cylinder2dRe{re}", "output", "forces-0.txt")
        dat = os.path.join(REPO, "examples", "data",
                           "koumoutsakos_leonard_1995_cylinder_"
                           f"dragCoefficientRe{re}.dat")
        if os.path.isfile(forces) and os.path.isfile(dat):
            cases.append((re, forces, dat))
    if not cases:
        print("kl_cd_overlay: no inputs, skipped")
        return False
    fig, axes = plt.subplots(1, len(cases), figsize=(4.6 * len(cases), 3.4),
                             sharey=False)
    axes = np.atleast_1d(axes)
    for ax, (re, forces, dat) in zip(axes, cases):
        data = np.loadtxt(forces)
        t, cd = data[:, 0], 2 * data[:, 1]
        tp, cdp = np.loadtxt(dat, unpack=True)
        tp = 0.5 * tp  # K&L plot t* = 2 t / D
        sel = tp <= t[-1] + 1e-9
        ax.plot(t, cd, **SIM)
        ax.plot(tp[sel], cdp[sel], **PUB,
                label="Koumoutsakos & Leonard 1995")
        ax.set(xlabel="t", ylabel="$C_D$", xlim=(0, t[-1]),
               ylim=(0, 2.0), title=f"Re = {re}")
    axes[0].legend(frameon=False, loc="upper right")
    fig.suptitle("Impulsively-started cylinder: drag history (coupled IBPM)",
                 fontsize=11)
    fig.tight_layout()
    out = os.path.join(FIGDIR, "kl_cd_overlay.png")
    fig.savefig(out)
    print(f"wrote {out}")
    return True


def cavity_centerlines() -> bool:
    import h5py
    from validate_cavity import GHIA_U, GHIA_V, RE_COL, interp_line

    res = [100, 1000, 3200, 5000]
    found = []
    for re in res:
        d = os.path.join(REPO, "examples", "navierstokes",
                         f"liddrivencavity2dRe{re}", "output")
        snaps = sorted(f for f in os.listdir(d) if f.endswith(".h5")
                       and f != "grid.h5") if os.path.isdir(d) else []
        if snaps:
            found.append((re, d, snaps[-1]))
    if not found:
        print("cavity_centerlines: no snapshots, skipped")
        return False
    fig, axes = plt.subplots(2, len(found),
                             figsize=(3.0 * len(found), 5.6))
    axes = axes.reshape(2, -1)
    for k, (re, d, snap) in enumerate(found):
        with h5py.File(os.path.join(d, "grid.h5")) as g:
            xu, yu = g["u/x"][:], g["u/y"][:]
            xv, yv = g["v/x"][:], g["v/y"][:]
        with h5py.File(os.path.join(d, snap)) as f:
            u, v = f["u"][:], f["v"][:]
        col = RE_COL[re]
        u_mid = np.array([interp_line(xu, u[j, :], 0.5)
                          for j in range(u.shape[0])])
        v_mid = np.array([interp_line(yv, v[:, i], 0.5)
                          for i in range(v.shape[1])])
        ax = axes[0, k]
        ax.plot(u_mid, yu, **SIM)
        ax.plot(GHIA_U[:, col], GHIA_U[:, 0], **PUB,
                label="Ghia et al. 1982")
        ax.set(title=f"Re = {re}", xlim=(-0.6, 1.05), ylim=(0, 1))
        if k == 0:
            ax.set(xlabel="u", ylabel="y")
            ax.legend(frameon=False, fontsize=8, loc="upper left")
        else:
            ax.set(xlabel="u")
        ax = axes[1, k]
        ax.plot(xv, v_mid, **SIM)
        ax.plot(GHIA_V[:, 0], GHIA_V[:, col], **PUB)
        ax.set(xlim=(0, 1))
        ax.set(xlabel="x", ylabel="v" if k == 0 else None)
    fig.suptitle("Lid-driven cavity: centerline profiles", fontsize=11)
    fig.tight_layout()
    out = os.path.join(FIGDIR, "cavity_centerlines.png")
    fig.savefig(out)
    print(f"wrote {out}")
    return True


def flatplate_aoa() -> bool:
    rec = os.path.join(REPO, "validation", "flatplate.json")
    if not os.path.isfile(rec):
        print("flatplate_aoa: no record, skipped")
        return False
    with open(rec) as fh:
        r = json.load(fh)
    pts = r.get("points", [])
    if not pts:
        return False
    aoa = [p["aoa"] for p in pts]
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(8.6, 3.4))
    for ax, key, name in ((a1, "cd", "$C_D$"), (a2, "cl", "$C_L$")):
        ax.plot(aoa, [p[key] for p in pts], marker="s", ms=4, **{
            k: v for k, v in SIM.items() if k != "label"},
            label="petibm-jax")
        ax.plot(aoa, [p[f"{key}_published"] for p in pts], **PUB,
                label="Taira et al. 2007 (exp: Taira & Colonius)")
        ax.set(xlabel="angle of attack (deg)", ylabel=name)
    a1.legend(frameon=False, fontsize=8)
    fig.suptitle("3D flat plate Re=100 AR=2: force coefficients vs AoA",
                 fontsize=11)
    fig.tight_layout()
    out = os.path.join(FIGDIR, "flatplate_aoa.png")
    fig.savefig(out)
    print(f"wrote {out}")
    return True


def main() -> int:
    os.makedirs(FIGDIR, exist_ok=True)
    plt.rcParams.update(STYLE)
    kl_overlay()
    cavity_centerlines()
    flatplate_aoa()
    return 0


if __name__ == "__main__":
    sys.exit(main())
