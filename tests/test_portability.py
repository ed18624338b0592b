"""What keeps the solver portable across backends and installations: no
backend-specific kernels in the package, the compile-cache location
rule, field output that can be turned off when h5py is missing, and no
multigrid hierarchy built where no V-cycle runs."""

import os
import pathlib
import subprocess
import sys

import pytest

from test_ibm import ib_config
from test_navierstokes import run_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "petibm_jax"


@pytest.mark.parametrize("needle", ["jax.experimental.pallas", "interpret="])
def test_package_has_no_pallas_kernels(needle):
    """Every operator compiles through XLA on every backend: nothing in
    the package imports Pallas or runs a kernel in interpret mode."""
    hits = [str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")
            if needle in p.read_text()]
    assert hits == []


@pytest.mark.parametrize("env_dir", [True, False],
                         ids=["env-set", "env-unset"])
def test_compile_cache_rule(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR is used as JAX reads it; without it the
    cache goes to <checkout>/.jax_cache.  Each branch in a fresh process,
    through the solver constructor."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = (
        "import sys, jax\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'tests')!r}]\n"
        "from test_navierstokes import run_config\n"
        "from petibm_jax.solvers.navierstokes import NavierStokesSolver\n"
        "import pathlib\n"
        f"cfg = run_config(pathlib.Path({str(tmp_path)!r}), nt=1, nsave=0,"
        " nrestart=0, n=8)\n"
        "NavierStokesSolver(cfg)\n"
        "print(jax.config.jax_compilation_cache_dir)\n")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    want = tmp_path / "cache" if env_dir else ROOT / ".jax_cache"
    assert res.stdout.strip().splitlines()[-1] == str(want)


def test_run_without_field_output_writes_no_hdf5(tmp_path):
    """nsave: 0 and nrestart: 0 run the solver with no HDF5 file at all,
    while the per-step iteration log is still written."""
    from petibm_jax.solvers.navierstokes import NavierStokesSolver

    s = NavierStokesSolver(run_config(tmp_path, nt=4, nsave=0, nrestart=0,
                                      n=8))
    s.run()
    s.close()
    assert list(tmp_path.rglob("*.h5")) == []
    lines = pathlib.Path(s.iter_log_path).read_text().splitlines()
    assert [int(line.split()[0]) for line in lines] == [1, 2, 3, 4]


def test_field_output_without_h5py_names_the_package(tmp_path, monkeypatch):
    """Asking for field output where h5py is missing fails at construction
    with an ImportError that names h5py and the way to run without it."""
    from petibm_jax.solvers.navierstokes import NavierStokesSolver

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py.*nsave: 0"):
        NavierStokesSolver(run_config(tmp_path, nt=2, nsave=2, n=8))


@pytest.mark.parametrize("solver,fdm", [
    ("navierstokes", True), ("decoupledibpm", True), ("ibpm", True),
    ("navierstokes", False)], ids=["ns", "decoupled", "coupled", "ns-mg"])
def test_mg_hierarchy_only_where_a_vcycle_runs(tmp_path, solver, fdm):
    """The FDM-direct default builds no multigrid hierarchy; fdm: false
    (MG-preconditioned CG) does."""
    from petibm_jax.solvers.decoupledibpm import DecoupledIBPMSolver
    from petibm_jax.solvers.ibpm import IBPMSolver
    from petibm_jax.solvers.navierstokes import NavierStokesSolver

    if solver == "navierstokes":
        cfg = run_config(tmp_path, nt=1, nsave=0, nrestart=0, n=8)
        cls = NavierStokesSolver
    else:
        cfg = ib_config(tmp_path, n=16, nt=1)
        cfg["parameters"].update(nsave=0, nrestart=0)
        cls = DecoupledIBPMSolver if solver == "decoupledibpm" else IBPMSolver
    if not fdm:
        cfg["parameters"]["fdm"] = False
    s = cls(cfg)
    assert (s.poisson_fdm is not None) == fdm
    assert (s.poisson_mg is None) == fdm
