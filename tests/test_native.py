"""Native hostcore: build, bindings, and agreement with the Python paths."""

import numpy as np
import pytest

from petibm_jax import native
from petibm_jax.ibm import body as body_mod
from petibm_jax.mesh import stretch_grid

pytestmark = pytest.mark.skipif(
    not native.available(), reason="hostcore toolchain unavailable")


def test_stretch_grid_matches_python(monkeypatch):
    got = native.stretch_grid(-1.0, 2.5, 37, 1.03)
    monkeypatch.setenv("PETIBM_NO_NATIVE", "1")
    h0 = (2.5 - -1.0) * 0.03 / (1.03**37 - 1.0)
    want = h0 * 1.03 ** np.arange(37)
    np.testing.assert_allclose(got, want, rtol=1e-13)
    assert got.sum() == pytest.approx(3.5, rel=1e-12)


def test_stretch_grid_uniform():
    got = native.stretch_grid(0.0, 1.0, 8, 1.0)
    np.testing.assert_allclose(got, np.full(8, 0.125), rtol=0, atol=0)


def test_body_roundtrip(tmp_path):
    rng = np.random.default_rng(7)
    coords = rng.uniform(-2, 2, size=(513, 3))
    path = str(tmp_path / "pts.body")
    assert native.write_lagrangian_points(path, coords, with_count=True)
    got = native.read_lagrangian_points(path)
    np.testing.assert_allclose(got, coords, rtol=1e-8, atol=1e-10)

    # the package-level reader (which prefers native) agrees too
    got2 = body_mod.read_lagrangian_points(path)
    np.testing.assert_allclose(got2, coords, rtol=1e-8, atol=1e-10)


def test_read_matches_python_reader(tmp_path):
    path = str(tmp_path / "tri.body")
    with open(path, "w") as fh:
        fh.write("3\n0.0 1.0\n-0.5 0.25\n2 3\n")
    native_read = native.read_lagrangian_points(path)
    want = np.array([[0.0, 1.0], [-0.5, 0.25], [2.0, 3.0]])
    np.testing.assert_array_equal(native_read, want)


def test_read_truncated_errors(tmp_path):
    path = str(tmp_path / "bad.body")
    with open(path, "w") as fh:
        fh.write("5\n0.0 1.0\n")
    with pytest.raises(ValueError):
        native.read_lagrangian_points(path)


def test_search_cells_matches_searchsorted():
    grid = np.cumsum(np.random.default_rng(0).uniform(0.1, 1.0, size=40))
    x = np.linspace(grid[0] + 1e-9, grid[-1] - 1e-9, 257)
    got = native.search_cells(grid, x)
    want = np.searchsorted(grid, x, side="right") - 1
    np.testing.assert_array_equal(got, want)
    # exact gridline hits belong to the upper cell (grid[i] <= x)
    got_edge = native.search_cells(grid, grid[:5].copy())
    want_edge = np.searchsorted(grid, grid[:5], side="right") - 1
    np.testing.assert_array_equal(got_edge, want_edge)


def test_mesh_stretch_grid_uses_native():
    # package-level stretch_grid returns identical values either way
    a = stretch_grid(0.0, 1.0, 16, 1.05)
    h0 = 0.05 / (1.05**16 - 1.0)
    np.testing.assert_allclose(a, h0 * 1.05 ** np.arange(16), rtol=1e-12)
