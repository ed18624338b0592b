"""chip_smoke.py where there is no GPU: it refuses to run (and reports
ok: false) both in the checkout and alone in a directory, and its
CPU-versus-device comparison helpers work on small CPU runs."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

from test_ibm import ib_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_gpu(tmp_path, where):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = pathlib.Path(shutil.copy(script, tmp_path))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] is False
    assert last["device"]["platform"] == "cpu"


def tiny_case(tmp_path) -> str:
    """A 16x16 decoupled-IBPM cylinder case directory."""
    src = tmp_path / "case"
    src.mkdir()
    cfg = ib_config(src, n=16, nt=3)
    for key in ("directory", "output", "logs"):
        cfg.pop(key)
    with open(src / "config.yaml", "w") as fh:
        yaml.safe_dump(cfg, fh)
    return str(src)


def test_cpu_runs_in_process_and_in_child_agree(tmp_path):
    """The same case run in this process and by the CPU-reference child
    process gives identical arrays; compare() passes them and flags a
    perturbed copy."""
    src = tiny_case(tmp_path)
    here = chip_smoke.check_run(chip_smoke.run_case(
        "decoupledibpm", chip_smoke.prepare_case(
            src, str(tmp_path / "a"), nt=3)), 3)
    child = chip_smoke.run_on_cpu(chip_smoke.prepare_case(
        src, str(tmp_path / "b"), nt=3))
    assert set(here) == set(child)
    assert here["forces"].shape[0] == 3
    res = chip_smoke.compare(child, here)
    assert res["ok"]
    assert res["force"] == res["velocity"] == res["pressure"] == 0.0
    assert set(chip_smoke.iterations_summary(here)) == {
        "v_iters", "p_iters", "f_iters"}

    bad = dict(here, q_u=here["q_u"] + 1e-3 * np.abs(here["q_u"]).max())
    res = chip_smoke.compare(child, bad)
    assert not res["ok"] and res["velocity"] == pytest.approx(1e-3)


def test_check_run_rejects_short_log(tmp_path):
    """A run whose log misses steps fails its checks."""
    src = tiny_case(tmp_path)
    solver = chip_smoke.run_case("decoupledibpm", chip_smoke.prepare_case(
        src, str(tmp_path / "a"), nt=2))
    with pytest.raises(AssertionError, match="ran to step 2, expected 3"):
        chip_smoke.check_run(solver, 3)
