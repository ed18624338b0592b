"""stepsPerDispatch: chunked (lax.scan) stepping must reproduce
single-step runs (to fusion-level rounding) and keep the per-step logs
identical."""

import numpy as np

from petibm_jax.solvers.decoupledibpm import DecoupledIBPMSolver
from petibm_jax.solvers.navierstokes import NavierStokesSolver

from test_parallel import cavity_config, cylinder_config


def _run(solver):
    solver.run()
    solver.close()
    return solver


def test_cavity_chunked_matches_single(tmp_path):
    a = tmp_path / "single"
    b = tmp_path / "chunked"
    a.mkdir(), b.mkdir()
    cfg_a = cavity_config(str(a))
    cfg_a["parameters"].update(nt=12, nsave=6, nrestart=12)
    sa = _run(NavierStokesSolver(cfg_a))
    cfg_b = cavity_config(str(b))
    cfg_b["parameters"].update(nt=12, nsave=6, nrestart=12,
                               stepsPerDispatch=4)
    sb = _run(NavierStokesSolver(cfg_b))
    assert sb._chunk_fn is not None
    np.testing.assert_allclose(np.asarray(sa.state["q"]["u"]),
                               np.asarray(sb.state["q"]["u"]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(sa.state["p"]),
                               np.asarray(sb.state["p"]),
                               rtol=0, atol=1e-12)
    # per-step iterations log: same number of lines, same iteration counts
    la = (a / "output" / "iterations-0.txt").read_text().splitlines()
    lb = (b / "output" / "iterations-0.txt").read_text().splitlines()
    assert len(la) == len(lb) == 12
    for ra, rb in zip(la, lb):
        assert ra.split("\t")[0] == rb.split("\t")[0]
        assert ra.split("\t")[1] == rb.split("\t")[1]  # v iters


def test_chunk_respects_host_event_boundaries(tmp_path):
    """nsave=5 with k=4: chunks must never cross a save point, so the
    sequence is 4,1,4,1 and both snapshots exist."""
    d = tmp_path / "case"
    d.mkdir()
    cfg = cavity_config(str(d))
    cfg["parameters"].update(nt=10, nsave=5, nrestart=10, stepsPerDispatch=4)
    s = NavierStokesSolver(cfg)
    seen = []
    orig_chunk, orig_single = s.advance_chunk, s.advance
    s.advance_chunk = lambda: (seen.append(s.steps_per_dispatch),
                               orig_chunk())[1]
    s.advance = lambda: (seen.append(1), orig_single())[1]
    s.run()
    s.close()
    assert seen == [4, 1, 4, 1]
    assert (d / "output" / "0000005.h5").exists()
    assert (d / "output" / "0000010.h5").exists()


def test_decoupledibpm_chunked_forces_log(tmp_path):
    a = tmp_path / "single"
    b = tmp_path / "chunked"
    a.mkdir(), b.mkdir()
    cfg_a = cylinder_config(str(a))
    cfg_a["parameters"].update(nt=8, nsave=8, nrestart=8)
    sa = _run(DecoupledIBPMSolver(cfg_a))
    cfg_b = cylinder_config(str(b))
    cfg_b["parameters"].update(nt=8, nsave=8, nrestart=8,
                               stepsPerDispatch=4)
    sb = _run(DecoupledIBPMSolver(cfg_b))
    np.testing.assert_allclose(np.asarray(sa.state["f"]),
                               np.asarray(sb.state["f"]),
                               rtol=0, atol=1e-10)
    fa = (a / "output" / "forces-0.txt").read_text().splitlines()
    fb = (b / "output" / "forces-0.txt").read_text().splitlines()
    assert len(fa) == len(fb) == 8
    for ra, rb in zip(fa, fb):
        va = [float(x) for x in ra.split("\t")]
        vb = [float(x) for x in rb.split("\t")]
        np.testing.assert_allclose(va, vb, rtol=0, atol=1e-10)
