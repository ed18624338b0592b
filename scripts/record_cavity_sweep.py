"""Run the four lid-driven-cavity example cases end-to-end and record
validation/cavity_ghia.json (or $PETIBM_VALIDATION_DIR/cavity_ghia.json):
the Ghia et al. 1982 centerline sweep (reference target:
doc/markdowns/examples2d.md:29).  Each case runs its example config to the
end, with field output off, and the centerlines are read from the final
solver state.

  python scripts/record_cavity_sweep.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

CASES = {100: "32x32", 1000: "128x128", 3200: "192x192", 5000: "256x256"}


def main() -> int:
    import numpy as np

    from petibm_jax.config import load_config
    from petibm_jax.solvers.navierstokes import NavierStokesSolver
    from petibm_jax.types import Field
    from validate_cavity import GHIA_U, GHIA_V, RE_COL, interp_line
    from validate_forces import device_detail

    results, ok = {}, True
    for re_, grid in CASES.items():
        d = os.path.join(REPO, "examples", "navierstokes",
                         f"liddrivencavity2dRe{re_}")
        out = tempfile.mkdtemp(prefix=f"cavity{re_}_")
        cfg = load_config(directory=d, output=out)
        # 1000-step dispatches (every example's nt is a multiple)
        cfg["parameters"].update(nsave=0, nrestart=0, stepsPerDispatch=1000)
        t0 = time.perf_counter()
        solver = NavierStokesSolver(cfg)
        solver.run()
        solver.close()
        run_s = time.perf_counter() - t0
        mesh = solver.mesh
        xu, yu = mesh.coord(Field.U, 0), mesh.coord(Field.U, 1)
        xv, yv = mesh.coord(Field.V, 0), mesh.coord(Field.V, 1)
        u = np.asarray(solver.state["q"]["u"], np.float64)
        v = np.asarray(solver.state["q"]["v"], np.float64)
        col = RE_COL[re_]
        u_mid = np.array([interp_line(xu, u[j, :], 0.5)
                          for j in range(u.shape[0])])
        u_sim = np.interp(GHIA_U[:, 0], yu, u_mid, left=0.0)
        u_sim[GHIA_U[:, 0] >= 1.0] = GHIA_U[GHIA_U[:, 0] >= 1.0, col]
        u_sim[GHIA_U[:, 0] <= 0.0] = 0.0
        v_mid = np.array([interp_line(yv, v[:, i], 0.5)
                          for i in range(v.shape[1])])
        v_sim = np.interp(GHIA_V[:, 0], xv, v_mid, left=0.0)
        v_sim[(GHIA_V[:, 0] <= 0.0) | (GHIA_V[:, 0] >= 1.0)] = 0.0
        u_rms = float(np.sqrt(np.mean((u_sim - GHIA_U[:, col]) ** 2)))
        v_rms = float(np.sqrt(np.mean((v_sim - GHIA_V[:, col]) ** 2)))
        steps = solver.ite
        results[f"Re{re_}"] = {
            "grid": grid, "steps": steps,
            "u_rms": round(u_rms, 5), "v_rms": round(v_rms, 5),
            "run_s": round(run_s)}
        ok = ok and u_rms <= 0.05 and v_rms <= 0.05
        print(json.dumps({f"Re{re_}": results[f"Re{re_}"]}))

    from provenance import provenance

    record = {
        "case": "liddrivencavity_ghia_sweep",
        "target": "centerline u/v RMS deviation vs Ghia et al. (1982) "
                  "tables I/II <= 0.05 (the reference validates the same "
                  "profiles, examples2d.md:29); grids/dt from the "
                  "reference-identical example configs",
        "results": results,
        "pass": bool(ok),
        "detail": {**device_detail(),
                   "dtype": "float32",
                   "note": "full example-config runs; centerline "
                           "comparison per scripts/validate_cavity.py",
                   "run_s_note": "run_s includes setup + XLA compile"},
        "provenance": provenance(),
    }
    line = json.dumps(record)
    print(line)
    vdir = os.environ.get("PETIBM_VALIDATION_DIR",
                          os.path.join(REPO, "validation"))
    os.makedirs(vdir, exist_ok=True)
    with open(os.path.join(vdir, "cavity_ghia.json"), "w") as fh:
        fh.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
