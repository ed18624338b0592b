"""IBM layer tests: delta kernels (reference: tests/misc/delta_test.cpp),
interpolation/spreading consistency, coupled-operator symmetry, and short
end-to-end runs of all three IBM solvers."""

import math
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from petibm_jax.ibm.delta import peskin_2002, roma_1999
from petibm_jax.ibm.body import BodyPack, read_lagrangian_points
from petibm_jax.ibm.interp import DeltaOp
from petibm_jax.mesh import StaggeredMesh
from petibm_jax.solvers.decoupledibpm import DecoupledIBPMSolver
from petibm_jax.solvers.ibpm import IBPMSolver
from petibm_jax.solvers.rigidkinematics import RigidKinematicsSolver
from petibm_jax.types import Field

from test_mesh import cavity_config

F64 = jnp.float64


def test_roma_kernel_properties():
    """Support, peak, unit-sum (reference: tests/misc/delta_test.cpp:21-43)."""
    h = 0.1
    assert float(roma_1999(jnp.asarray(0.16), h)) == 0.0
    assert float(roma_1999(jnp.asarray(0.0), h)) == pytest.approx(2 / (3 * h))
    # partition of unity on shifted lattices
    for shift in (0.0, 0.3, 0.71):
        pts = (np.arange(-4, 5) + shift) * h
        s = float(jnp.sum(roma_1999(jnp.asarray(pts), h)) * h)
        assert s == pytest.approx(1.0, abs=1e-12)
    # monotonic decay
    xs = jnp.asarray(np.linspace(0, 0.15, 10))
    vals = np.asarray(roma_1999(xs, h))
    assert np.all(np.diff(vals) <= 1e-12)


def test_peskin_kernel_properties():
    h = 0.05
    assert float(peskin_2002(jnp.asarray(0.11), h)) == 0.0
    for shift in (0.0, 0.4):
        pts = (np.arange(-5, 6) + shift) * h
        s = float(jnp.sum(peskin_2002(jnp.asarray(pts), h)) * h)
        assert s == pytest.approx(1.0, abs=1e-12)


def make_body_file(tmp_path, n=20, r=0.2, center=(0.5, 0.5)):
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    path = tmp_path / "circle.body"
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for t in theta:
            fh.write(f"{center[0] + r * np.cos(t):.10e}\t"
                     f"{center[1] + r * np.sin(t):.10e}\n")
    return str(path)


def ib_config(tmp_path, n=30, nt=5, solver_extra=None):
    cfg = cavity_config(n, n)
    cfg["flow"]["initialVelocity"] = [1.0, 0.0]
    cfg["flow"]["boundaryConditions"] = [
        {"location": "xMinus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
        {"location": "xPlus", "u": ["CONVECTIVE", 1.0], "v": ["CONVECTIVE", 1.0]},
        {"location": "yMinus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
        {"location": "yPlus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
    ]
    cfg["parameters"] = {
        "dt": 0.01, "startStep": 0, "nt": nt, "nsave": nt, "nrestart": nt,
        "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
        "velocitySolver": {"type": "CPU"},
        "poissonSolver": {"type": "CPU"},
        "forcesSolver": {"type": "CPU"},
    }
    if solver_extra:
        cfg["parameters"].update(solver_extra)
    cfg["bodies"] = [{"type": "points", "file": make_body_file(tmp_path)}]
    cfg["directory"] = str(tmp_path)
    cfg["output"] = str(tmp_path / "output")
    cfg["logs"] = str(tmp_path / "output" / "logs")
    return cfg


def test_body_reading_and_mesh_idx(tmp_path):
    cfg = ib_config(tmp_path)
    mesh = StaggeredMesh(cfg)
    pack = BodyPack(cfg, mesh)
    assert pack.n_bodies == 1 and pack.n_pts == 20
    body = pack.bodies[0]
    idx = body.mesh_idx(mesh)
    # every point's owning cell must contain the point
    verts = mesh.coord(Field.VERTEX, 0)
    for k in range(body.n_pts):
        i = idx[k, 0]
        assert verts[i] <= body.coords[k, 0] <= verts[i + 1]


def test_interpolation_recovers_linear_field(tmp_path):
    """E applied to a linear velocity field reproduces it at the body points
    (kernel moments: the Roma kernel is exact for linears on uniform grids)."""
    cfg = ib_config(tmp_path)
    mesh = StaggeredMesh(cfg)
    pack = BodyPack(cfg, mesh)
    op = DeltaOp(mesh, "ROMA_ET_AL_1999", F64)
    X = jnp.asarray(pack.all_coords(), F64)
    win = op.windows(X)
    a, b, c = 0.7, 1.3, -0.4
    xu = mesh.bcast(Field.U, 0, mesh.coord(Field.U, 0))
    yu = mesh.bcast(Field.U, 1, mesh.coord(Field.U, 1))
    xv = mesh.bcast(Field.V, 0, mesh.coord(Field.V, 0))
    yv = mesh.bcast(Field.V, 1, mesh.coord(Field.V, 1))
    q = {"u": jnp.asarray(np.broadcast_to(a + b * xu + c * yu,
                                          mesh.shape(Field.U)), F64),
         "v": jnp.asarray(np.broadcast_to(a + b * xv + c * yv,
                                          mesh.shape(Field.V)), F64)}
    eu = np.asarray(op.interpolate(q, win))
    Xn = np.asarray(X)
    expect_u = a + b * Xn[:, 0] + c * Xn[:, 1]
    np.testing.assert_allclose(eu[:, 0], expect_u, rtol=1e-10)
    np.testing.assert_allclose(eu[:, 1], expect_u, rtol=1e-10)


def test_spread_conserves_total_force(tmp_path):
    """sum over grid of vol * (H f) per component equals sum of f (the
    delta kernel's unit integral), away from boundaries."""
    cfg = ib_config(tmp_path)
    mesh = StaggeredMesh(cfg)
    pack = BodyPack(cfg, mesh)
    op = DeltaOp(mesh, "ROMA_ET_AL_1999", F64)
    win = op.windows(jnp.asarray(pack.all_coords(), F64))
    rng = np.random.default_rng(0)
    f = jnp.asarray(rng.standard_normal((pack.n_pts, 2)))
    hf = op.spread(f, win)
    for c, name in enumerate(("u", "v")):
        vol = np.ones(mesh.shape(Field(c)))
        for d in range(2):
            vol = vol * mesh.bcast(Field(c), d, mesh.dl(Field(c), d))
        total = float(np.sum(np.asarray(hf[name]) * vol))
        assert total == pytest.approx(float(jnp.sum(f[:, c])), rel=1e-10)


def test_eh_adjoint_relation(tmp_path):
    """<E u, f> = <u, vol * H f>: E = Delta*vol and H = Delta^T."""
    cfg = ib_config(tmp_path)
    mesh = StaggeredMesh(cfg)
    pack = BodyPack(cfg, mesh)
    op = DeltaOp(mesh, "ROMA_ET_AL_1999", F64)
    win = op.windows(jnp.asarray(pack.all_coords(), F64))
    rng = np.random.default_rng(1)
    q = {"u": jnp.asarray(rng.standard_normal(mesh.shape(Field.U))),
         "v": jnp.asarray(rng.standard_normal(mesh.shape(Field.V)))}
    f = jnp.asarray(rng.standard_normal((pack.n_pts, 2)))
    lhs = float(jnp.sum(op.interpolate(q, win) * f))
    hf = op.spread(f, win)
    rhs = 0.0
    for c, name in enumerate(("u", "v")):
        vol = np.ones(mesh.shape(Field(c)))
        for d in range(2):
            vol = vol * mesh.bcast(Field(c), d, mesh.dl(Field(c), d))
        rhs += float(jnp.sum(q[name] * jnp.asarray(vol) * hf[name]))
    assert lhs == pytest.approx(rhs, rel=1e-12)


def test_decoupled_ibpm_short_run(tmp_path):
    solver = DecoupledIBPMSolver(ib_config(tmp_path, nt=5))
    solver.run()
    solver.close()
    out = tmp_path / "output"
    assert (out / "forces-0.txt").exists()
    lines = (out / "forces-0.txt").read_text().strip().splitlines()
    assert len(lines) == 5 and len(lines[0].split("\t")) == 3
    # drag on a bluff body in a stream is positive
    assert float(lines[-1].split("\t")[1]) > 0.0
    # restart file has the forces
    with h5py.File(out / "0000005.h5") as fh:
        assert fh["force/0"].shape == (40,)
    # iterations log has 3 solver columns
    cols = (out / "iterations-0.txt").read_text().splitlines()[0].split("\t")
    assert len(cols) == 7


def test_ibpm_coupled_operator_symmetric(tmp_path):
    """Dense-probe the coupled operator: symmetric, pressure-constant
    nullspace (ibpm.cpp:242-283)."""
    cfg = ib_config(tmp_path, n=12)
    solver = IBPMSolver(cfg)
    pshape = solver.mesh.shape(Field.P)
    npts = solver.bodies.n_pts
    nP = int(np.prod(pshape))
    nF = npts * 2

    def apply_flat(v):
        phi = {"p": jnp.asarray(v[:nP].reshape(pshape)),
               "f": jnp.asarray(v[nP:].reshape(npts, 2))}
        w = solver.bn(solver._G_combined(phi))
        out_p = solver.div(w, None, homogeneous=True)
        out_f = solver.delta.interpolate(w, solver._win)
        return np.concatenate([np.asarray(out_p).ravel(),
                               np.asarray(out_f).ravel()])

    n = nP + nF
    M = np.stack([apply_flat(np.eye(n)[k]) for k in range(n)], axis=1)
    np.testing.assert_allclose(M, M.T, atol=1e-11)
    null = np.concatenate([np.ones(nP), np.zeros(nF)])
    np.testing.assert_allclose(M @ null, 0.0, atol=1e-11)
    w = np.linalg.eigvalsh(M)
    assert w[-1] < 1e-10  # negative semidefinite
    solver.close()


def test_ibpm_short_run(tmp_path):
    solver = IBPMSolver(ib_config(tmp_path, nt=5))
    solver.run()
    solver.close()
    out = tmp_path / "output"
    lines = (out / "forces-0.txt").read_text().strip().splitlines()
    assert len(lines) == 5
    assert float(lines[-1].split("\t")[1]) > 0.0  # positive drag


def test_ibpm_direct_schur_matches_cg(tmp_path):
    """The setup-time Schur-complement solve (default: CG preconditioned
    by the exact block inverse; coupledMode 'direct' = plain refinement)
    and the retained outer-CG path solve the same {p, f} block system:
    5-step force histories agree to the f32 conditioning floor, and the
    Schur paths converge in a handful of passes, not a Krylov loop."""
    da, dd, db = tmp_path / "a", tmp_path / "d", tmp_path / "b"
    da.mkdir(), dd.mkdir(), db.mkdir()
    sa = IBPMSolver(ib_config(da, nt=5))
    sa.run()
    fa = np.asarray(sa.state["f"])
    sa.close()
    lines = (da / "output" / "iterations-0.txt").read_text().strip()
    p_iters = [int(l.split("\t")[3]) for l in lines.splitlines()]
    assert max(p_iters) <= 6  # exact-inverse-preconditioned CG

    sd = IBPMSolver(ib_config(dd, nt=5,
                              solver_extra={"coupledMode": "direct"}))
    assert getattr(sd._coupled_solver, "__qualname__",
                   "").startswith("make_fdm_solver")
    sd.run()
    fd = np.asarray(sd.state["f"])
    sd.close()

    sb = IBPMSolver(ib_config(db, nt=5,
                              solver_extra={"coupledDirect": False}))
    assert not getattr(sb._coupled_solver, "__qualname__",
                       "").startswith("make_fdm_solver")
    sb.run()
    fb = np.asarray(sb.state["f"])
    sb.close()
    scale = np.abs(fb).max()
    assert np.abs(fa - fb).max() <= 0.03 * scale
    assert np.abs(fa - fd).max() <= 0.01 * scale  # same Schur inverse


def test_rigidkinematics_oscillation_smoke(tmp_path):
    cfg = ib_config(tmp_path, nt=3)
    cfg["bodies"][0]["kinematics"] = {
        "type": "oscillation", "f": 0.2, "D": 0.4, "KC": 2.0}
    solver = RigidKinematicsSolver(cfg)
    solver.run()
    solver.close()
    out = tmp_path / "output"
    # body files written at step 0 and final save
    assert (out / "body00_0000000.2D").exists()
    assert (out / "body00_0000003.2D").exists()
    c0 = np.loadtxt(out / "body00_0000000.2D")
    c3 = np.loadtxt(out / "body00_0000003.2D")
    # body moved in x only
    assert abs(c0[:, 0].mean() - c3[:, 0].mean()) > 1e-6
    np.testing.assert_allclose(c0[:, 1], c3[:, 1], atol=1e-12)


def test_rigidkinematics_warm_inverse_matches_krylov(tmp_path):
    """Moving bodies solve EBNH df = rhsf with the coords0 warm inverse +
    matrix-free refinement (dense fallback under lax.cond); it must agree
    with the matrix-free Krylov path (forcesSolver dense: false) on the
    same trajectory."""
    da, db = tmp_path / "a", tmp_path / "b"
    da.mkdir(), db.mkdir()
    kin = {"type": "oscillation", "f": 0.2, "D": 0.4, "KC": 2.0}

    cfg = ib_config(da, nt=6)
    cfg["bodies"][0]["kinematics"] = dict(kin)
    sa = RigidKinematicsSolver(cfg)
    sa.run()
    fa = np.asarray(sa.state["f"])
    sa.close()

    cfg2 = ib_config(db, nt=6)
    cfg2["bodies"][0]["kinematics"] = dict(kin)
    cfg2["parameters"]["forcesSolver"] = {"type": "CPU", "dense": False,
                                          "atol": 1e-9, "max_it": 2000}
    sb = RigidKinematicsSolver(cfg2)
    sb.run()
    fb = np.asarray(sb.state["f"])
    sb.close()
    scale = max(np.abs(fb).max(), 1e-30)
    assert np.abs(fa - fb).max() <= 2e-3 * scale


def make_sphere_file(tmp_path, r=0.15, center=(0.5, 0.5, 0.5)):
    """Fibonacci-lattice sphere point set, 3-column body file
    (reference 3D body format: io::readLagrangianPoints, src/io/io.cpp:23)."""
    n = 40
    k = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * k / n)
    theta = np.pi * (1 + np.sqrt(5.0)) * k
    pts = np.stack([center[0] + r * np.sin(phi) * np.cos(theta),
                    center[1] + r * np.sin(phi) * np.sin(theta),
                    center[2] + r * np.cos(phi)], axis=1)
    path = tmp_path / "sphere.body"
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for p in pts:
            fh.write(f"{p[0]:.10e}\t{p[1]:.10e}\t{p[2]:.10e}\n")
    return str(path)


def ib3d_config(tmp_path, n=16, nt=3):
    """Sphere in a uniform stream (the 3D analogue of ib_config; the
    reference's 3D IBM case: examples3d.md flat plate, here a sphere)."""
    from test_physics import cavity3d_config

    cfg = cavity3d_config(tmp_path, n=n, nt=nt)
    cfg["flow"]["initialVelocity"] = [1.0, 0.0, 0.0]
    bcs = []
    for loc in ("xMinus", "yMinus", "yPlus", "zMinus", "zPlus"):
        bcs.append({"location": loc, "u": ["DIRICHLET", 1.0],
                    "v": ["DIRICHLET", 0.0], "w": ["DIRICHLET", 0.0]})
    bcs.append({"location": "xPlus", "u": ["CONVECTIVE", 1.0],
                "v": ["CONVECTIVE", 1.0], "w": ["CONVECTIVE", 1.0]})
    cfg["flow"]["boundaryConditions"] = bcs
    cfg["parameters"]["forcesSolver"] = {"type": "CPU"}
    cfg["bodies"] = [{"type": "points", "file": make_sphere_file(tmp_path)}]
    return cfg


def test_decoupled_ibpm_3d_sphere(tmp_path):
    """3D decoupled IBPM end-to-end: runs, positive drag, no-slip enforced
    at the body, 4-column forces log (t, fx, fy, fz)."""
    solver = DecoupledIBPMSolver(ib3d_config(tmp_path))
    solver.run()
    out = tmp_path / "output"
    lines = (out / "forces-0.txt").read_text().strip().splitlines()
    assert len(lines) == 3 and len(lines[0].split("\t")) == 4
    assert float(lines[-1].split("\t")[1]) > 0.0  # positive drag
    # velocity interpolated to the body points is small (no-slip is enforced
    # pre-projection; the Poisson projection perturbs it O(grid) on this
    # deliberately coarse 16^3 mesh — same behavior as the reference scheme)
    ub = solver.delta.interpolate(solver.state["q"], solver._static_windows)
    assert float(jnp.max(jnp.abs(ub))) < 0.5  # well below the 1.0 stream
    with h5py.File(out / "0000003.h5") as fh:
        assert fh["force/0"].shape == (40 * 3,)
    solver.close()


def test_decoupled_ibpm_multibody(tmp_path):
    """Two cylinders (reference: examples/decoupledibpm/multicylinders2dRe100):
    per-body force columns in the log, packed force vector."""
    cfg = ib_config(tmp_path, nt=3)
    theta = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    second = tmp_path / "circle2.body"
    with open(second, "w") as fh:
        fh.write("16\n")
        for t in theta:
            fh.write(f"{0.3 + 0.1 * np.cos(t):.10e}\t"
                     f"{0.7 + 0.1 * np.sin(t):.10e}\n")
    cfg["bodies"].append({"type": "points", "file": str(second)})
    solver = DecoupledIBPMSolver(cfg)
    assert solver.bodies.n_bodies == 2
    assert solver.bodies.n_pts == 20 + 16
    solver.run()
    lines = (tmp_path / "output" / "forces-0.txt").read_text().strip().splitlines()
    assert len(lines) == 3
    # t + (fx, fy) per body
    assert len(lines[0].split("\t")) == 5
    # both bluff bodies see positive drag in the uniform stream
    last = [float(v) for v in lines[-1].split("\t")]
    assert last[1] > 0.0 and last[3] > 0.0
    solver.close()


def test_dense_ebnh_matches_matrix_free(tmp_path):
    """BN=1 dense force system: the (N, N) component blocks built from the
    window factor matrices must act identically to E B_N H, and the direct
    solve must agree with the Krylov solve."""
    import jax.numpy as jnp

    cfg = ib_config(tmp_path, nt=1)
    solver = DecoupledIBPMSolver(cfg)
    win = solver._static_windows
    mats = solver._dense_ebnh_blocks(win)
    n = solver.bodies.n_pts
    rng = np.random.default_rng(7)
    f = jnp.asarray(rng.standard_normal((n, solver.mesh.dim)))
    want = np.asarray(solver._ebnh(f, win))
    got = np.stack([np.asarray(mats[c]) @ np.asarray(f[:, c])
                    for c in range(solver.mesh.dim)], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    # direct solve vs Krylov solve of the same system
    rhs = jnp.asarray(rng.standard_normal((n, solver.mesh.dim)))
    df_dense = solver._solve_forces(rhs, win).x
    from petibm_jax.linalg import make_solver

    krylov = make_solver(lambda df: solver._ebnh(df, win),
                         {"type": "cg", "atol": 1e-12, "max_it": 2000})
    df_kry = krylov(rhs, jnp.zeros_like(rhs)).x
    np.testing.assert_allclose(np.asarray(df_dense), np.asarray(df_kry),
                               rtol=0, atol=1e-8)


def test_dense_opt_out_uses_krylov(tmp_path):
    cfg = ib_config(tmp_path, nt=1)
    cfg["parameters"]["forcesSolver"] = {"type": "CPU", "dense": False,
                                         "atol": 1e-10, "max_it": 500}
    solver = DecoupledIBPMSolver(cfg)
    solver.advance()
    stats = jax.device_get(solver._last_stats)
    assert int(stats["f_iters"]) > 0  # Krylov path iterates


def test_restart_exact_with_convective_bc(tmp_path):
    """Restart must reproduce the continuous run bit-exactly INCLUDING
    convective-BC ghost state — the reference only re-initializes it and
    carries a TODO (navierstokes.cpp:742); here a1/value are saved in the
    restart extras."""
    cfg = ib_config(tmp_path, nt=6)
    cfg["parameters"]["nsave"] = 3
    cfg["parameters"]["nrestart"] = 3
    solver = DecoupledIBPMSolver(cfg)
    solver.run()
    cont = jax.device_get(solver.state)
    solver.close()

    cfg2 = ib_config(tmp_path, nt=3)  # nt counts steps from startStep
    cfg2["parameters"]["nsave"] = 3
    cfg2["parameters"]["nrestart"] = 3
    cfg2["parameters"]["startStep"] = 3
    restarted = DecoupledIBPMSolver(cfg2)
    restarted.run()
    rest = jax.device_get(restarted.state)
    restarted.close()

    for name in ("u", "v"):
        np.testing.assert_array_equal(np.asarray(rest["q"][name]),
                                      np.asarray(cont["q"][name]))
    np.testing.assert_array_equal(np.asarray(rest["p"]),
                                  np.asarray(cont["p"]))
    np.testing.assert_array_equal(np.asarray(rest["f"]),
                                  np.asarray(cont["f"]))
    # the BC ghost state itself round-trips exactly
    for key in cont["bc"]:
        for part in ("a1", "value"):
            np.testing.assert_array_equal(
                np.asarray(rest["bc"][key][part]),
                np.asarray(cont["bc"][key][part]))


# ----------------------------------------------------------------------
# windowed (large-body) delta engine: ibm/interp.py WindowedDeltaOp


def test_windowed_delta_matches_factor_engine(tmp_path):
    """The gather/scatter windowed engine and the MXU factor-matrix engine
    are two layouts of the same operator: E and H results must agree to
    rounding, in 2D and with a periodic direction."""
    from petibm_jax.ibm.interp import WindowedDeltaOp

    cfg = ib_config(tmp_path)
    mesh = StaggeredMesh(cfg)
    pack = BodyPack(cfg, mesh)
    X = jnp.asarray(pack.all_coords(), F64)
    rng = np.random.default_rng(4)

    a = DeltaOp(mesh, "ROMA_ET_AL_1999", F64)
    b = WindowedDeltaOp(mesh, "ROMA_ET_AL_1999", F64)
    wa, wb = a.windows(X), b.windows(X)

    q = {"u": jnp.asarray(rng.standard_normal(mesh.shape(Field.U)), F64),
         "v": jnp.asarray(rng.standard_normal(mesh.shape(Field.V)), F64)}
    np.testing.assert_allclose(np.asarray(a.interpolate(q, wa)),
                               np.asarray(b.interpolate(q, wb)),
                               rtol=0, atol=1e-12)
    f = jnp.asarray(rng.standard_normal((X.shape[0], 2)), F64)
    ha, hb = a.spread(f, wa), b.spread(f, wb)
    for k in ("u", "v"):
        np.testing.assert_allclose(np.asarray(ha[k]), np.asarray(hb[k]),
                                   rtol=0, atol=1e-12)
    # the shared banded reductions (diag(E B1 H) etc.) agree per layout
    for c in range(2):
        for d in range(2):
            sa = jnp.sum(wa[c]["sd"][d] * wa[c]["sv"][d], axis=1)
            sb = jnp.sum(wb[c]["sd"][d] * wb[c]["sv"][d], axis=1)
            np.testing.assert_allclose(np.asarray(sa), np.asarray(sb),
                                       rtol=0, atol=1e-13)


def test_windowed_delta_solver_equivalence(tmp_path):
    """A short decoupled-IBPM run with deltaEngine forced to 'windowed'
    (matrix-free Krylov forces) matches the factor-engine run."""
    os.makedirs(tmp_path / "a", exist_ok=True)
    os.makedirs(tmp_path / "b", exist_ok=True)
    # tight tolerances: the windowed run solves forces with matrix-free
    # Krylov (no dense blocks), so loose defaults would leave a
    # tolerance-level gap between the two runs rather than an
    # operator-level one
    tight = {"forcesSolver": {"type": "CPU", "atol": 1e-12},
             "velocitySolver": {"type": "CPU", "atol": 1e-12},
             "poissonSolver": {"type": "CPU", "atol": 1e-12}}
    cfg_a = ib_config(tmp_path / "a", solver_extra=tight)
    cfg_b = ib_config(tmp_path / "b", solver_extra=tight)
    cfg_a["parameters"]["forcesSolver"]["dense"] = False
    cfg_b["parameters"]["deltaEngine"] = "windowed"
    sa = DecoupledIBPMSolver(cfg_a)
    sb = DecoupledIBPMSolver(cfg_b)
    assert not sa.delta.windowed and sb.delta.windowed
    for _ in range(3):
        sa.state, _ = sa._step_fn(sa.state)
        sb.state, _ = sb._step_fn(sb.state)
    np.testing.assert_allclose(np.asarray(sb.state["q"]["u"]),
                               np.asarray(sa.state["q"]["u"]), atol=1e-8)
    np.testing.assert_allclose(np.asarray(sb.state["f"]),
                               np.asarray(sa.state["f"]), atol=1e-6)
    sa.close(), sb.close()


def test_windowed_delta_auto_threshold(tmp_path):
    from petibm_jax.ibm.interp import (WINDOWED_THRESHOLD, WindowedDeltaOp,
                                       make_delta_op)

    cfg = ib_config(tmp_path)
    mesh = StaggeredMesh(cfg)
    small = make_delta_op(mesh, n_pts=100)
    big = make_delta_op(mesh, n_pts=WINDOWED_THRESHOLD + 1)
    assert not small.windowed
    assert isinstance(big, WindowedDeltaOp)


def test_windowed_delta_matches_factor_engine_3d():
    """3D layout equivalence of the two delta engines (the chunked
    expansion's axis handling differs from 2D)."""
    from petibm_jax.ibm.interp import WindowedDeltaOp

    cfg = {
        "mesh": [
            {"direction": "x", "start": -1.0,
             "subDomains": [{"end": 1.0, "cells": 18, "stretchRatio": 1.03}]},
            {"direction": "y", "start": -1.0,
             "subDomains": [{"end": 1.0, "cells": 14, "stretchRatio": 1.0}]},
            {"direction": "z", "start": -1.0,
             "subDomains": [{"end": 1.0, "cells": 12, "stretchRatio": 1.0}]},
        ],
        "flow": {"nu": 0.01, "initialVelocity": [0, 0, 0],
                 "boundaryConditions": [
                     {"location": loc, "u": ["DIRICHLET", 0.0],
                      "v": ["DIRICHLET", 0.0], "w": ["DIRICHLET", 0.0]}
                     for loc in ("xMinus", "xPlus", "yMinus", "yPlus",
                                 "zMinus", "zPlus")]},
    }
    mesh = StaggeredMesh(cfg)
    rng = np.random.default_rng(6)
    # sphere-ish point cloud inside the domain
    npts = 40
    th = rng.uniform(0, 2 * np.pi, npts)
    ph = np.arccos(rng.uniform(-1, 1, npts))
    X = jnp.asarray(0.4 * np.stack([np.cos(th) * np.sin(ph),
                                    np.sin(th) * np.sin(ph),
                                    np.cos(ph)], axis=1), F64)

    a = DeltaOp(mesh, "ROMA_ET_AL_1999", F64)
    b = WindowedDeltaOp(mesh, "ROMA_ET_AL_1999", F64)
    wa, wb = a.windows(X), b.windows(X)
    q = {k: jnp.asarray(rng.standard_normal(mesh.shape(Field(c))), F64)
         for c, k in enumerate(("u", "v", "w"))}
    np.testing.assert_allclose(np.asarray(a.interpolate(q, wa)),
                               np.asarray(b.interpolate(q, wb)),
                               rtol=0, atol=1e-12)
    f = jnp.asarray(rng.standard_normal((npts, 3)), F64)
    ha, hb = a.spread(f, wa), b.spread(f, wb)
    for k in ("u", "v", "w"):
        np.testing.assert_allclose(np.asarray(ha[k]), np.asarray(hb[k]),
                                   rtol=0, atol=1e-12)


def test_ibpm_coupled_restart_exact(tmp_path):
    """Coupled-IBPM restart (force + dPhi extras, ibpm.cpp:338-384) must
    reproduce the continuous run bit-exactly."""
    cfg = ib_config(tmp_path, nt=6)
    cfg["parameters"]["nsave"] = 3
    cfg["parameters"]["nrestart"] = 3
    solver = IBPMSolver(cfg)
    solver.run()
    cont = jax.device_get(solver.state)
    solver.close()

    cfg2 = ib_config(tmp_path, nt=3)
    cfg2["parameters"]["nsave"] = 3
    cfg2["parameters"]["nrestart"] = 3
    cfg2["parameters"]["startStep"] = 3
    restarted = IBPMSolver(cfg2)
    restarted.run()
    rest = jax.device_get(restarted.state)
    restarted.close()

    for name in ("u", "v"):
        np.testing.assert_array_equal(np.asarray(rest["q"][name]),
                                      np.asarray(cont["q"][name]))
    np.testing.assert_array_equal(np.asarray(rest["p"]),
                                  np.asarray(cont["p"]))
    np.testing.assert_array_equal(np.asarray(rest["f"]),
                                  np.asarray(cont["f"]))
    for part in ("p", "f"):
        np.testing.assert_array_equal(np.asarray(rest["dPhi"][part]),
                                      np.asarray(cont["dPhi"][part]))


def test_ibpm_pinned_backend_matches_projection(tmp_path):
    """poissonSolver type: GPU on the COUPLED solver selects the pinned
    (AmgX-parity) treatment, now solved via the Schur-direct pinned
    adapter (projected solve + compatibility shift + gauge fix).  Forces
    must match the mean-projection backend; pressures differ by at most
    a constant."""
    da, db = tmp_path / "a", tmp_path / "b"
    da.mkdir(), db.mkdir()
    sa = IBPMSolver(ib_config(da, nt=5))
    sa.run()
    fa, pa = np.asarray(sa.state["f"]), np.asarray(sa.state["p"])
    sa.close()
    sb = IBPMSolver(ib_config(db, nt=5, solver_extra={
        "poissonSolver": {"type": "GPU"}}))
    assert sb.is_ref_p
    sb.run()
    fb, pb = np.asarray(sb.state["f"]), np.asarray(sb.state["p"])
    sb.close()
    scale = np.abs(fb).max()
    assert np.abs(fa - fb).max() <= 0.03 * scale
    d = (pa - pa.mean()) - (pb - pb.mean())
    assert np.abs(d).max() <= 0.05 * max(np.abs(pb - pb.mean()).max(), 1e-12)
