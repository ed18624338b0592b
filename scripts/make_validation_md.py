"""Render VALIDATION.md from the recorded validation/*.json results
(produced by scripts/validate_forces.py; see tests/test_validation.py for
the asserted brackets)."""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEADER = """# VALIDATION — recorded physics results

Force-coefficient validation of the BASELINE.md parity cases, produced by
`python scripts/validate_forces.py <case>` (each case runs the full solver
end-to-end and reduces its forces log).  `tests/test_validation.py` asserts
these recorded numbers against the published brackets on every test run,
and the `-m slow` tier re-runs the cases from scratch.

Reference evidence being matched: `doc/markdowns/examples2d.md:78-136`
(drag vs Koumoutsakos & Leonard 1995), the oscillating-cylinder api
example (Dutsch et al. 1998), the 3D sphere (Johnson & Patel 1999), the
K&L Cd(t) *curve* comparisons for the impulsively-started Re=550/Re=3000
cylinders against the reference's vendored digitized datasets
(`examples/data/koumoutsakos_leonard_1995_*.dat`; the reference's own
documented K&L validation also runs the coupled IBPM, examples2d.md:125),
and the 3D flat-plate AoA sweep vs the Dickinson experimental data
(`examples/data/taira_et_al_2007_*.dat`, examples3d.md).
"""

ROWS = [
    ("re40", "Cylinder Re=40 (decoupled IBPM, 186^2 stretched)",
     "Cd(t=20) = 1.5-1.6 (Koumoutsakos & Leonard 1995)",
     lambda r: f"Cd(t={r['t_final']:g}) = {r['cd_final']}"),
    ("re200", "Cylinder Re=200 (decoupled IBPM, 450^2 stretched)",
     "mean Cd ~ 1.25-1.45, Cl amp ~ 0.55-0.75, St ~ 0.19-0.21 "
     "(Braza et al. 1986; Liu et al. 1998)",
     lambda r: (f"mean Cd = {r['cd_mean']}, Cl amp = {r['cl_amp']}, "
                f"St = {r['strouhal']} (to t={r['t_final']:g})")),
    ("oscillating", "In-line oscillating cylinder Re=100 KC=5 "
     "(rigid kinematics, 512^2)",
     "Morison fit CD ~ 2.09, CM ~ 1.45 (Dutsch et al. 1998)",
     lambda r: f"CD = {r['cd_morison']}, CM = {r['cm_morison']}"),
    ("sphere300", "Sphere Re=300 (decoupled IBPM, 160x130x130, 3D)",
     "Cd ~ 0.63-0.68, Cl ~ 0.04-0.09 (Johnson & Patel 1999)",
     lambda r: f"mean Cd = {r['cd_mean']}, mean |Cl| = {r['cl_mean']}"),
    ("re550", "Cylinder Re=550 impulsive start (coupled IBPM, 450^2)",
     "Cd(t) history vs Koumoutsakos & Leonard 1995, t in [0.5, 3]",
     lambda r: (f"rms dev = {r['curve_vs_koumoutsakos_leonard_1995']['rms_dev']}, "
                f"max = {r['curve_vs_koumoutsakos_leonard_1995']['max_abs_dev']} "
                f"over {r['curve_vs_koumoutsakos_leonard_1995']['n_published_samples']} samples")),
    ("re3000", "Cylinder Re=3000 impulsive start (coupled IBPM, 986^2)",
     "Cd(t) history vs Koumoutsakos & Leonard 1995, t in [0.5, 3]",
     lambda r: (f"rms dev = {r['curve_vs_koumoutsakos_leonard_1995']['rms_dev']}, "
                f"max = {r['curve_vs_koumoutsakos_leonard_1995']['max_abs_dev']} "
                f"over {r['curve_vs_koumoutsakos_leonard_1995']['n_published_samples']} samples")),
    ("tgv3d", "Taylor-Green vortex 3D Re=1600 (navierstokes, 256^3 "
     "periodic DNS)",
     "peak dissipation -dE/dt ~ 0.0122 at t ~ 9.0 (van Rees et al. 2011 "
     "spectral DNS; 2nd-order envelope [0.010, 0.0135] x [8, 10])",
     lambda r: (f"peak eps = {r['peak_dissipation']} at "
                f"t = {r['peak_time']}")),
    ("cavity_ghia", "Lid-driven cavity Re=100/1000/3200/5000 "
     "(navierstokes, reference-identical grids)",
     "centerline u/v RMS vs Ghia et al. (1982) <= 0.05",
     lambda r: ", ".join(
         f"{re}: {max(v['u_rms'], v['v_rms']):.3f}"
         for re, v in r["results"].items())),
    ("multicylinders", "Two-cylinder y-periodic array Re=100 "
     "(decoupled IBPM, 511x500, 20% blockage)",
     "per-body Cd ~ 1.6-1.9, St ~ 0.18-0.22 (Sahin & Owens 2004 confined "
     "cylinder at beta=0.2); symmetric pair matches",
     lambda r: (f"Cd = {r['bodies'][0]['cd_mean']}/{r['bodies'][1]['cd_mean']}"
                f" (gap {r['cd_symmetry_gap']}), St = "
                f"{r['bodies'][0]['strouhal']}")),
    ("flatplate", "Flat plate 3D AR=2 Re=100, AoA 0-40 deg (decoupled IBPM, "
     "127x56x84)",
     "time-averaged Cd/Cl vs Dickinson experiment (Taira et al. 2007), "
     "within 0.15 at every angle",
     lambda r: (f"worst abs dev = {r['worst_abs_dev']} across "
                f"{len(r['points'])} angles (Cl within 0.04)")),
]


def main() -> int:
    lines = [HEADER]
    lines.append("| Case | Published target | Result | Pass | Steps | "
                 "Device (name, power limit) | ms/step |")
    lines.append("|---|---|---|---|---|---|---|")
    for case, title, target, fmt in ROWS:
        path = os.path.join(REPO, "validation", f"{case}.json")
        if not os.path.isfile(path):
            lines.append(f"| {title} | {target} | _not yet recorded_ "
                         f"(`scripts/validate_forces.py {case}`) | — | — |"
                         " — | — |")
            continue
        with open(path) as fh:
            r = json.load(fh)
        d = r.get("detail", {})
        steady = d.get("steady_ms_per_step")
        ms = (f"{steady} steady" if steady is not None
              else d.get("ms_per_step"))
        lines.append(
            f"| {title} | {target} | {fmt(r)} | "
            f"{'PASS' if r.get('pass') else 'FAIL'} | {d.get('steps')} | "
            f"{d.get('gpu') or d.get('platform')} | "
            f"{ms} |")
    lines.append("")
    lines.append("Raw records: `validation/<case>.json`.  Cavity Re=100 "
                 "vs Ghia et al. 1982 and the Taylor-Green analytic decay "
                 "are asserted numerically in the default test suite "
                 "(`tests/test_navierstokes.py::test_cavity_ghia_validation`, "
                 "`tests/test_physics.py`).")
    out = os.path.join(REPO, "VALIDATION.md")
    with open(out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
