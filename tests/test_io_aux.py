"""Probes, vorticity, and XDMF tests (reference subsystems: probes.cpp,
applications/vorticity, applications/createxdmf)."""

import os

import h5py
import jax.numpy as jnp
import numpy as np

from petibm_jax.boundary import BoundarySet
from petibm_jax.io.probes import ProbePoint, ProbeVolume, create_probe
from petibm_jax.io.vorticity import compute_vorticity, vorticity_meshes
from petibm_jax.io.xdmf import write_single_xdmf
from petibm_jax.mesh import StaggeredMesh
from petibm_jax.solvers.navierstokes import NavierStokesSolver
from petibm_jax.types import Field

from test_mesh import cavity_config
from test_navierstokes import run_config


def test_volume_probe_box_and_gating(tmp_path):
    cfg = cavity_config(8, 8)
    mesh = StaggeredMesh(cfg)
    node = {"type": "VOLUME", "field": "p", "path": str(tmp_path / "probe.h5"),
            "viewer": "hdf5", "n_monitor": 2,
            "box": {"x": [0.2, 0.6], "y": [0.2, 0.6]}}
    probe = create_probe(node, mesh)
    # pressure centers in [0.2, 0.6]: 0.21875..0.59375 -> indices 2..4
    assert probe.start == [1, 1] or probe.npts[0] > 0
    xs = probe.sub_coords[0]
    assert np.all((xs > 0.2 - 1e-6) & (xs < 0.6 + 1e-6))
    p = jnp.asarray(np.arange(64, dtype=np.float64).reshape(8, 8))
    fields = {"p": p}
    probe.monitor(fields, n=1, t=0.1)   # gated out (n_monitor=2)
    probe.monitor(fields, n=2, t=0.2)   # recorded
    probe.monitor(fields, n=4, t=99.0)  # recorded (t_end default huge)
    with h5py.File(node["path"]) as fh:
        assert "mesh/x" in fh and "mesh/IS" in fh
        keys = sorted(fh["p"].keys())
        assert len(keys) == 2
        sub = np.asarray(fh["p"][keys[0]])
        np.testing.assert_allclose(
            sub, np.asarray(p)[probe._slices()])


def test_volume_probe_time_average(tmp_path):
    cfg = cavity_config(6, 6)
    mesh = StaggeredMesh(cfg)
    node = {"type": "VOLUME", "field": "p", "path": str(tmp_path / "avg.h5"),
            "viewer": "hdf5", "n_sum": 3,
            "box": {"x": [0.0, 1.0], "y": [0.0, 1.0]}}
    probe = create_probe(node, mesh)
    for n in range(1, 7):
        probe.monitor({"p": jnp.full((6, 6), float(n))}, n=n, t=0.01 * n)
    with h5py.File(node["path"]) as fh:
        keys = sorted(fh["p"].keys())
        assert len(keys) == 2  # two accumulation cycles of 3 steps
        np.testing.assert_allclose(np.asarray(fh["p"][keys[0]]), 2.0)  # (1+2+3)/3
        np.testing.assert_allclose(np.asarray(fh["p"][keys[1]]), 5.0)
        assert fh["p"][keys[0]].attrs["count"] == 3


def test_point_probe_interpolates_linear_field(tmp_path):
    cfg = cavity_config(8, 8)
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    node = {"type": "POINT", "field": "u", "path": str(tmp_path / "pt.txt"),
            "loc": [0.43, 0.57]}
    probe = ProbePoint(node, mesh, bcs)
    a, b, c = 0.2, 1.5, -0.8
    xu = mesh.bcast(Field.U, 0, mesh.coord(Field.U, 0))
    yu = mesh.bcast(Field.U, 1, mesh.coord(Field.U, 1))
    u = jnp.asarray(np.broadcast_to(a + b * xu + c * yu, mesh.shape(Field.U)))
    q = {"u": u, "v": jnp.zeros(mesh.shape(Field.V))}
    fields = {"u": u, "_bcstate": bcs.init_state(q)}
    probe.monitor(fields, n=1, t=0.5)
    probe.close()
    t, val = np.loadtxt(node["path"])
    assert t == 0.5
    np.testing.assert_allclose(val, a + b * 0.43 + c * 0.57, rtol=1e-12)


def test_vorticity_rigid_rotation(tmp_path):
    """u = -y, v = x  ->  wz = 2 at interior vertices."""
    cfg = cavity_config(10, 10)
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    xu = mesh.bcast(Field.U, 0, mesh.coord(Field.U, 0))
    yu = mesh.bcast(Field.U, 1, mesh.coord(Field.U, 1))
    xv = mesh.bcast(Field.V, 0, mesh.coord(Field.V, 0))
    yv = mesh.bcast(Field.V, 1, mesh.coord(Field.V, 1))
    q = {"u": jnp.asarray(np.broadcast_to(-yu + 0 * xu, mesh.shape(Field.U))),
         "v": jnp.asarray(np.broadcast_to(xv + 0 * yv, mesh.shape(Field.V)))}
    state = bcs.init_state(q)
    w = compute_vorticity(mesh, bcs, q, state)
    assert w["wz"].shape == (11, 11)
    np.testing.assert_allclose(w["wz"][1:-1, 1:-1], 2.0, rtol=1e-12)
    # grid definition matches the vertex mesh
    grids = vorticity_meshes(mesh)
    np.testing.assert_allclose(grids["wz"][0], mesh.coord(Field.VERTEX, 0))


def test_probes_through_solver(tmp_path):
    cfg = run_config(tmp_path, nt=4)
    cfg["probes"] = [
        {"type": "POINT", "field": "u", "path": "probe-u.txt",
         "loc": [0.5, 0.75]},
        {"type": "VOLUME", "field": "p", "viewer": "hdf5",
         "path": "probe-p.h5", "box": {"x": [0.0, 1.0], "y": [0.4, 0.6]}},
    ]
    solver = NavierStokesSolver(cfg)
    solver.run()
    solver.close()
    out = tmp_path / "output"
    pts = np.loadtxt(out / "probe-u.txt")
    assert pts.shape == (4, 2)
    with h5py.File(out / "probe-p.h5") as fh:
        assert len(fh["p"].keys()) == 4


def test_xdmf_structure(tmp_path):
    path = write_single_xdmf(str(tmp_path), "u", 2, (15, 16, 1), 0, 100, 50)
    text = open(path).read()
    assert "3DRectMesh" in text
    assert "grid.h5:/u/x" in text
    assert "0000050.h5:/u" in text and "0000100.h5:/u" in text
    assert text.count("<Grid GridType=\"Uniform\"") == 3


def test_amgx_solver_options_parsed(tmp_path):
    """The reference's GPU cases point solver configs at AmgX key=value
    files (examples/ibpm/cylinder2dRe550_GPU/config/poisson_solver.info,
    consumed by linsolveramgx.cpp:54-126); those must carry over with
    tolerances honored, with nested-scope knobs (the AMG preconditioner's
    own max_iters=1) correctly ignored."""
    from petibm_jax.config import parse_solver_options

    path = tmp_path / "poisson_solver.info"
    path.write_text("""\
config_version=2
communicator=MPI
determinism_flag=1

solver(solv)=PCG
solv:max_iters=1000
solv:monitor_residual=1
solv:convergence=ABSOLUTE
solv:tolerance=1.0E-06
solv:norm=L2
solv:preconditioner(prec)=AMG

prec:algorithm=AGGREGATION
prec:max_iters=1
prec:cycle=V
prec:smoother(smooth)=BLOCK_JACOBI
smooth:relaxation_factor=0.9
""")
    opts = parse_solver_options(str(path))
    assert opts["type"] == "cg"
    assert opts["atol"] == 1e-6 and opts["rtol"] == 0.0
    assert opts["max_it"] == 1000  # NOT the preconditioner's 1
    assert opts["pc"] == "mg" and opts["pc_explicit"]

    # relative convergence maps to rtol; BiCGStab velocity configs
    path2 = tmp_path / "velocity_solver.info"
    path2.write_text("solver(s)=PBICGSTAB\ns:convergence=RELATIVE_INI_CORE\n"
                     "s:tolerance=1.0E-05\ns:max_iters=300\n")
    opts2 = parse_solver_options(str(path2))
    assert opts2["type"] == "bicgstab"
    assert opts2["rtol"] == 1e-5 and opts2["atol"] == 0.0
    assert opts2["max_it"] == 300

    # PETSc-format files keep taking the PETSc path
    path3 = tmp_path / "petsc.info"
    path3.write_text("-poisson_ksp_type cg\n-poisson_ksp_atol 1.0E-08\n")
    assert parse_solver_options(str(path3))["atol"] == 1e-8


def test_amgx_gpu_case_carries_over():
    """The shipped cylinder2dRe550_GPU case (reference AmgX wiring) must
    resolve its Poisson tolerances from the AmgX file and select the
    pinned-pressure (GPU) backend."""
    import os

    from petibm_jax.config import load_config, solver_config

    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "ibpm",
        "cylinder2dRe550_GPU")
    cfg = load_config(directory=d)
    popts = solver_config(cfg, "poisson")
    assert popts["backend"] == "GPU"
    assert popts["atol"] == 1e-6 and popts["rtol"] == 0.0
    assert popts["max_it"] == 20000
    assert popts["pc"] == "mg" and popts["pc_explicit"]
    vopts = solver_config(cfg, "velocity")
    assert vopts["type"] == "bicgstab" and vopts["atol"] == 1e-6
