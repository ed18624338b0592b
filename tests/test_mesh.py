"""Mesh tests mirroring the reference's tests/mesh expectations
(reference: tests/mesh/cartesianmesh2d_dirichlet.cpp,
cartesianmesh2d_yperiodic.cpp): grid sizes, coordinates, cell widths,
ghost conventions, periodic velocity-point append."""

import numpy as np
import pytest

from petibm_jax.mesh import StaggeredMesh, stretch_grid
from petibm_jax.types import Field


def cavity_config(nx=32, ny=32, bc="DIRICHLET"):
    return {
        "mesh": [
            {"direction": "x", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": nx, "stretchRatio": 1.0}]},
            {"direction": "y", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": ny, "stretchRatio": 1.0}]},
        ],
        "flow": {
            "nu": 0.01,
            "initialVelocity": [0.0, 0.0],
            "boundaryConditions": [
                {"location": loc, "u": [bc, 0.0], "v": [bc, 0.0]}
                for loc in ("xMinus", "xPlus", "yMinus", "yPlus")
            ],
        },
    }


def periodic_config(nx=8, ny=6):
    cfg = cavity_config(nx, ny)
    cfg["flow"]["boundaryConditions"] = [
        {"location": "xMinus", "u": ["PERIODIC", 0.0], "v": ["PERIODIC", 0.0]},
        {"location": "xPlus", "u": ["PERIODIC", 0.0], "v": ["PERIODIC", 0.0]},
        {"location": "yMinus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
        {"location": "yPlus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
    ]
    return cfg


def test_stretch_grid_sum_and_ratio():
    dl = stretch_grid(0.0, 2.0, 10, 1.1)
    assert dl.shape == (10,)
    np.testing.assert_allclose(dl.sum(), 2.0, rtol=1e-12)
    np.testing.assert_allclose(dl[1:] / dl[:-1], 1.1, rtol=1e-12)
    # uniform special case
    dl = stretch_grid(0.0, 1.0, 4, 1.0)
    np.testing.assert_allclose(dl, 0.25)


def test_uniform_cavity_mesh_shapes():
    m = StaggeredMesh(cavity_config(32, 32))
    assert m.dim == 2
    # non-periodic: u has np-1 x-points, np y-points
    # (reference: cartesianmesh.cpp:227, 285)
    assert m.shape(Field.U) == (32, 31)
    assert m.shape(Field.V) == (31, 32)
    assert m.shape(Field.P) == (32, 32)
    assert m.shape(Field.VERTEX) == (33, 33)
    assert m.pN == 1024
    assert m.UN == 32 * 31 * 2


def test_uniform_cavity_coordinates():
    m = StaggeredMesh(cavity_config(4, 4))
    h = 0.25
    np.testing.assert_allclose(m.coord(Field.P, 0), [h / 2, 3 * h / 2, 5 * h / 2, 7 * h / 2])
    np.testing.assert_allclose(m.coord(Field.U, 0), [h, 2 * h, 3 * h])
    np.testing.assert_allclose(m.coord(Field.U, 1), m.coord(Field.P, 1))
    np.testing.assert_allclose(m.coord(Field.VERTEX, 0), [0, h, 2 * h, 3 * h, 4 * h])
    # ghost coordinates: u-x ghosts on the domain faces
    gx = m.coord_ghosted(Field.U, 0)
    assert gx[0] == 0.0 and gx[-1] == 1.0
    # u-y ghosts mirror the edge cells (reference: cartesianmesh.cpp:316-320)
    gy = m.coord_ghosted(Field.U, 1)
    np.testing.assert_allclose(gy[0], -h / 2)
    np.testing.assert_allclose(gy[-1], 1 + h / 2)


def test_uniform_cavity_dl():
    m = StaggeredMesh(cavity_config(4, 4))
    h = 0.25
    np.testing.assert_allclose(m.dl(Field.U, 0), [h, h, h])
    np.testing.assert_allclose(m.dl(Field.U, 1), [h, h, h, h])
    g = m.dl_ghosted(Field.U, 0)
    np.testing.assert_allclose(g[0], h)   # ghost dL = first pressure cell
    np.testing.assert_allclose(g[-1], h)  # ghost dL = last pressure cell


def test_stretched_mesh_widths():
    cfg = cavity_config()
    cfg["mesh"][0]["subDomains"] = [
        {"end": 0.5, "cells": 5, "stretchRatio": 0.8},
        {"end": 1.0, "cells": 5, "stretchRatio": 1.25},
    ]
    m = StaggeredMesh(cfg)
    dxp = m.dxp[0]
    assert len(dxp) == 10
    np.testing.assert_allclose(dxp.sum(), 1.0, rtol=1e-12)
    # u-grid dL = half-sum of adjacent pressure cells
    # (reference: cartesianmesh.cpp:236-247)
    np.testing.assert_allclose(m.dl(Field.U, 0), 0.5 * (dxp[:-1] + dxp[1:]))
    # laplacian neighbor distances are ghost-aware
    line = m.lines[Field.U][0]
    np.testing.assert_allclose(line.dneg()[0], dxp[0])
    np.testing.assert_allclose(line.dpos()[-1], dxp[-1])


def test_periodic_velocity_append():
    m = StaggeredMesh(periodic_config(8, 6))
    assert m.periodic == [True, False]
    # periodic comp-dir keeps the max-face point: n = np
    # (reference: cartesianmesh.cpp:251-273)
    assert m.shape(Field.U) == (6, 8)
    assert m.shape(Field.V) == (5, 8)
    cu = m.coord(Field.U, 0)
    assert len(cu) == 8
    np.testing.assert_allclose(cu[-1], 1.0)  # point on the max face
    g = m.coord_ghosted(Field.U, 0)
    np.testing.assert_allclose(g[0], 0.0)            # image of max-face point
    np.testing.assert_allclose(g[-1], 1.0 + 1 / 8)   # image of 1st interior
    # dL of the max-face point = half-sum of first+last pressure cells
    np.testing.assert_allclose(m.dl(Field.U, 0)[-1], 0.5 * (1 / 8 + 1 / 8))
    # v-grid x ghosts are periodic images (reference: cartesianmesh.cpp:301-311)
    gv = m.coord_ghosted(Field.V, 0)
    np.testing.assert_allclose(gv[0], -1 / 16)
    np.testing.assert_allclose(gv[-1], 1 + 1 / 16)


def test_3d_mesh_shapes():
    cfg = {
        "mesh": [
            {"direction": "x", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": 6, "stretchRatio": 1.0}]},
            {"direction": "y", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": 5, "stretchRatio": 1.0}]},
            {"direction": "z", "start": 0.0,
             "subDomains": [{"end": 1.0, "cells": 4, "stretchRatio": 1.0}]},
        ],
        "flow": {
            "nu": 0.01,
            "initialVelocity": [0.0, 0.0, 0.0],
            "boundaryConditions": [
                {"location": loc, "u": ["DIRICHLET", 0.0],
                 "v": ["DIRICHLET", 0.0], "w": ["DIRICHLET", 0.0]}
                for loc in ("xMinus", "xPlus", "yMinus", "yPlus",
                            "zMinus", "zPlus")
            ],
        },
    }
    m = StaggeredMesh(cfg)
    assert m.dim == 3
    assert m.shape(Field.U) == (4, 5, 5)   # (nz, ny, nx-1)
    assert m.shape(Field.V) == (4, 4, 6)
    assert m.shape(Field.W) == (3, 5, 6)
    assert m.shape(Field.P) == (4, 5, 6)


def test_mismatched_periodic_raises():
    cfg = periodic_config()
    cfg["flow"]["boundaryConditions"][1]["u"] = ["DIRICHLET", 0.0]
    with pytest.raises(ValueError):
        StaggeredMesh(cfg)
