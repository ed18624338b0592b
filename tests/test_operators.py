"""Operator tests: BC ghost relations, stencil exactness on polynomial
fields, symmetry of the composed Poisson operator, diagonal probing, and
Krylov convergence (SURVEY.md §7 step 2 validation plan)."""

import jax
import jax.numpy as jnp
import numpy as np

from petibm_jax.boundary import BoundarySet
from petibm_jax.linalg import bicgstab, cg, extract_diagonal
from petibm_jax.mesh import StaggeredMesh
from petibm_jax.operators import (
    make_bn,
    make_convection,
    make_divergence,
    make_gradient,
    make_laplacian,
)
from petibm_jax.types import Field

from test_mesh import cavity_config, periodic_config

F64 = jnp.float64


def setup(cfg):
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    return mesh, bcs


def linear_fields(mesh, coeffs=(1.3, -0.7, 0.4)):
    """u = a + b*x + c*y (+ d*z) sampled on each staggered grid."""
    names = ("u", "v", "w")
    out = {}
    for c in range(mesh.dim):
        f = Field(c)
        val = coeffs[0]
        for d in range(mesh.dim):
            val = val + coeffs[1 + d] * mesh.bcast(f, d, mesh.coord(f, d))
        out[names[c]] = jnp.asarray(np.broadcast_to(val, mesh.shape(f)), F64)
    return out


def test_dirichlet_extend():
    mesh, bcs = setup(cavity_config(4, 4))
    q = {"u": jnp.full(mesh.shape(Field.U), 2.0, F64),
         "v": jnp.zeros(mesh.shape(Field.V), F64)}
    cfg = cavity_config(4, 4)
    cfg["flow"]["boundaryConditions"][3]["u"] = ["DIRICHLET", 1.0]  # yPlus lid
    mesh, bcs = setup(cfg)
    state = bcs.init_state(q)
    ext = bcs.extend(q["u"], 0, state)
    # same-dir face (xMinus): ghost = BC value (a0=0, a1=value)
    np.testing.assert_allclose(ext[1:-1, 0], 0.0)
    # perpendicular face (yPlus lid u=1): ghost = 2*value - target
    np.testing.assert_allclose(ext[-1, 1:-1], 2.0 * 1.0 - 2.0)
    # homogeneous variant drops a1
    exth = bcs.extend(q["u"], 0, None, homogeneous=True)
    np.testing.assert_allclose(exth[1:-1, 0], 0.0)
    np.testing.assert_allclose(exth[-1, 1:-1], -2.0)


def test_neumann_extend():
    cfg = cavity_config(4, 4)
    cfg["flow"]["boundaryConditions"][0]["u"] = ["NEUMANN", 3.0]  # xMinus
    mesh, bcs = setup(cfg)
    q = {"u": jnp.full(mesh.shape(Field.U), 5.0, F64),
         "v": jnp.zeros(mesh.shape(Field.V), F64)}
    state = bcs.init_state(q)
    ext = bcs.extend(q["u"], 0, state)
    # ghost = target + normal*dL*value; xMinus normal=-1, dL = 0.25
    np.testing.assert_allclose(ext[1:-1, 0], 5.0 - 0.25 * 3.0)


def test_periodic_extend_wraps():
    mesh, bcs = setup(periodic_config(8, 6))
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(mesh.shape(Field.U)), F64)
    q = {"u": u, "v": jnp.zeros(mesh.shape(Field.V), F64)}
    state = bcs.init_state(q)
    ext = bcs.extend(u, 0, state, dirs=(0,))
    np.testing.assert_allclose(ext[:, 0], u[:, -1])
    np.testing.assert_allclose(ext[:, -1], u[:, 0])


def test_gradient_exact_on_linear_pressure():
    mesh, bcs = setup(cavity_config(8, 8))
    grad = make_gradient(mesh, F64)
    a, b = 2.0, -3.0
    p = (a * mesh.bcast(Field.P, 0, mesh.coord(Field.P, 0))
         + b * mesh.bcast(Field.P, 1, mesh.coord(Field.P, 1)))
    g = grad(jnp.asarray(np.broadcast_to(p, mesh.shape(Field.P)), F64))
    np.testing.assert_allclose(g["u"], a, rtol=1e-12)
    np.testing.assert_allclose(g["v"], b, rtol=1e-12)


def test_gradient_periodic_wrap():
    mesh, _ = setup(periodic_config(8, 6))
    grad = make_gradient(mesh, F64)
    p = jnp.asarray(np.arange(48, dtype=np.float64).reshape(6, 8))
    g = grad(p)
    assert g["u"].shape == (6, 8)
    # last u column: (p[:,0] - p[:,7]) / dL
    np.testing.assert_allclose(np.asarray(g["u"][:, -1]),
                               (np.asarray(p[:, 0]) - np.asarray(p[:, 7])) / 0.125)


def test_divergence_of_linear_velocity():
    """div(b*x, c*y) = (b + c) * cell volume with the area-weighted D."""
    cfg = cavity_config(6, 5)
    # make BC values consistent with the linear field so the ghost fill
    # reproduces the analytic values on the boundary faces
    mesh = StaggeredMesh(cfg)
    a, b, c = 0.0, 1.5, -0.6
    # u = b*x, v = c*y; same-dir Dirichlet values vary per face
    cfg["flow"]["boundaryConditions"] = [
        {"location": "xMinus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
        {"location": "xPlus", "u": ["DIRICHLET", b * 1.0], "v": ["DIRICHLET", 0.0]},
        {"location": "yMinus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
        {"location": "yPlus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", c * 1.0]},
    ]
    mesh, bcs = setup(cfg)
    div = make_divergence(mesh, bcs, F64)
    xu = mesh.bcast(Field.U, 0, mesh.coord(Field.U, 0))
    yv = mesh.bcast(Field.V, 1, mesh.coord(Field.V, 1))
    q = {"u": jnp.asarray(np.broadcast_to(b * xu, mesh.shape(Field.U)), F64),
         "v": jnp.asarray(np.broadcast_to(c * yv, mesh.shape(Field.V)), F64)}
    state = bcs.init_state(q)
    d = div(q, state)
    vol = (mesh.bcast(Field.P, 0, mesh.dl(Field.P, 0))
           * mesh.bcast(Field.P, 1, mesh.dl(Field.P, 1)))
    np.testing.assert_allclose(np.asarray(d), (b + c) * vol, rtol=1e-12)


def test_laplacian_uniform_interior():
    """On a uniform grid, L of a quadratic x^2 is exactly 2 at interior
    points away from boundaries."""
    mesh, bcs = setup(cavity_config(8, 8))
    lap = make_laplacian(mesh, bcs, F64)
    xu = mesh.bcast(Field.U, 0, mesh.coord(Field.U, 0))
    q = {"u": jnp.asarray(np.broadcast_to(xu**2, mesh.shape(Field.U)), F64),
         "v": jnp.zeros(mesh.shape(Field.V), F64)}
    state = bcs.init_state(q)
    out = lap(q, state)
    np.testing.assert_allclose(np.asarray(out["u"][2:-2, 2:-2]), 2.0, rtol=1e-10)


def dense_matrix(op, shape):
    """Materialize a pressure-space operator by probing basis vectors."""
    n = int(np.prod(shape))
    cols = []
    for k in range(n):
        e = np.zeros(n)
        e[k] = 1.0
        cols.append(np.asarray(op(jnp.asarray(e.reshape(shape)))).ravel())
    return np.stack(cols, axis=1)


def make_poisson(mesh, bcs, dt=1.0):
    grad = make_gradient(mesh, F64)
    div = make_divergence(mesh, bcs, F64)
    lap = make_laplacian(mesh, bcs, F64)
    bn = make_bn(lap, dt, 0.0, 1)

    def A(phi):
        return div(bn(grad(phi)), None, homogeneous=True)

    return A


def test_poisson_operator_symmetric_and_singular():
    cfg = cavity_config(5, 4)
    cfg["mesh"][0]["subDomains"][0]["stretchRatio"] = 1.3  # stretched
    mesh, bcs = setup(cfg)
    A = make_poisson(mesh, bcs)
    M = dense_matrix(A, mesh.shape(Field.P))
    np.testing.assert_allclose(M, M.T, atol=1e-12)
    # constant nullspace: row sums are zero (reference: setNullSpace,
    # navierstokes.cpp:395-429)
    np.testing.assert_allclose(M @ np.ones(M.shape[0]), 0.0, atol=1e-12)
    # negative semidefinite with rank n-1
    w = np.linalg.eigvalsh(M)
    assert w[-1] < 1e-12 and np.sum(np.abs(w) < 1e-10) == 1


def test_poisson_operator_periodic_symmetric():
    mesh, bcs = setup(periodic_config(6, 5))
    A = make_poisson(mesh, bcs)
    M = dense_matrix(A, mesh.shape(Field.P))
    np.testing.assert_allclose(M, M.T, atol=1e-12)
    np.testing.assert_allclose(M @ np.ones(M.shape[0]), 0.0, atol=1e-12)


def test_extract_diagonal_matches_dense():
    cfg = cavity_config(5, 4)
    cfg["mesh"][1]["subDomains"][0]["stretchRatio"] = 0.9
    mesh, bcs = setup(cfg)
    A = make_poisson(mesh, bcs)
    M = dense_matrix(A, mesh.shape(Field.P))
    diag = extract_diagonal(A, jnp.zeros(mesh.shape(Field.P), F64), radius=1)
    np.testing.assert_allclose(np.asarray(diag).ravel(), np.diag(M), atol=1e-12)


def test_extract_diagonal_periodic():
    mesh, bcs = setup(periodic_config(7, 5))  # odd length stresses coloring
    A = make_poisson(mesh, bcs)
    M = dense_matrix(A, mesh.shape(Field.P))
    diag = extract_diagonal(A, jnp.zeros(mesh.shape(Field.P), F64), radius=1)
    np.testing.assert_allclose(np.asarray(diag).ravel(), np.diag(M), atol=1e-12)


def test_cg_solves_poisson():
    mesh, bcs = setup(cavity_config(8, 8))
    A = make_poisson(mesh, bcs)

    def negA(phi):  # CG needs SPD; Poisson operator is negative semidefinite
        return -A(phi)

    rng = np.random.default_rng(1)
    b = rng.standard_normal(mesh.shape(Field.P))
    b -= b.mean()
    b = jnp.asarray(b)
    res = cg(negA, b, jnp.zeros_like(b), atol=1e-10, rtol=0.0, maxiter=500)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(negA(res.x)), np.asarray(b), atol=1e-8)


def test_bicgstab_solves_momentum_like_system():
    mesh, bcs = setup(cavity_config(8, 8))
    lap = make_laplacian(mesh, bcs, F64)
    dt, nu, cimp = 0.01, 0.01, 0.5

    def A(q):
        lq = lap(q, None, homogeneous=True)
        return jax.tree_util.tree_map(lambda u, l: u / dt - cimp * nu * l, q, lq)

    rng = np.random.default_rng(2)
    b = {"u": jnp.asarray(rng.standard_normal(mesh.shape(Field.U))),
         "v": jnp.asarray(rng.standard_normal(mesh.shape(Field.V)))}
    x0 = jax.tree_util.tree_map(jnp.zeros_like, b)
    res = bicgstab(A, b, x0, atol=1e-10, rtol=0.0, maxiter=500)
    assert bool(res.converged)
    out = A(res.x)
    np.testing.assert_allclose(np.asarray(out["u"]), np.asarray(b["u"]), atol=1e-8)


def test_convection_translation_invariant_uniform_flow():
    """N(u) of a uniform stream with matching BCs is zero."""
    cfg = cavity_config(6, 6)
    U0 = 1.0
    cfg["flow"]["boundaryConditions"] = [
        {"location": loc, "u": ["DIRICHLET", U0], "v": ["DIRICHLET", 0.0]}
        for loc in ("xMinus", "xPlus", "yMinus", "yPlus")
    ]
    mesh, bcs = setup(cfg)
    conv = make_convection(mesh, bcs, F64)
    q = {"u": jnp.full(mesh.shape(Field.U), U0, F64),
         "v": jnp.zeros(mesh.shape(Field.V), F64)}
    state = bcs.init_state(q)
    n = conv(q, state)
    np.testing.assert_allclose(np.asarray(n["u"]), 0.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(n["v"]), 0.0, atol=1e-12)


def test_convection_hand_computed_2d():
    """Check one interior u-point against the reference kernelU formula
    (createconvection.cpp:40-63) evaluated by hand."""
    mesh, bcs = setup(cavity_config(5, 5))
    conv = make_convection(mesh, bcs, F64)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(mesh.shape(Field.U))
    v = rng.standard_normal(mesh.shape(Field.V))
    q = {"u": jnp.asarray(u), "v": jnp.asarray(v)}
    state = bcs.init_state(q)
    out = np.asarray(conv(q, state)["u"])
    i, j = 2, 2  # interior: no ghosts involved
    h = 0.2
    uself = u[j, i]
    uW = 0.5 * (uself + u[j, i - 1]); uE = 0.5 * (uself + u[j, i + 1])
    uS = 0.5 * (uself + u[j - 1, i]); uN = 0.5 * (uself + u[j + 1, i])
    vS = 0.5 * (v[j - 1, i] + v[j - 1, i + 1])
    vN = 0.5 * (v[j, i] + v[j, i + 1])
    expected = (uE**2 - uW**2) / h + (vN * uN - vS * uS) / h
    np.testing.assert_allclose(out[j, i], expected, rtol=1e-12)


def test_bn_order1_is_dt_identity():
    """B_1 = dt*I (reference: tests/operators/createbnhead_test.cpp:17-74)."""
    mesh, bcs = setup(cavity_config(4, 4))
    lap = make_laplacian(mesh, bcs, F64)
    bn = make_bn(lap, 0.02, 0.5 * 0.01, 1)
    q = {"u": jnp.ones(mesh.shape(Field.U), F64),
         "v": jnp.full(mesh.shape(Field.V), 2.0, F64)}
    out = bn(q)
    np.testing.assert_allclose(np.asarray(out["u"]), 0.02)
    np.testing.assert_allclose(np.asarray(out["v"]), 0.04)


def test_bn_order2_series():
    mesh, bcs = setup(cavity_config(4, 4))
    lap = make_laplacian(mesh, bcs, F64)
    dt, coeff = 0.02, 0.005
    bn2 = make_bn(lap, dt, coeff, 2)
    rng = np.random.default_rng(4)
    q = {"u": jnp.asarray(rng.standard_normal(mesh.shape(Field.U))),
         "v": jnp.asarray(rng.standard_normal(mesh.shape(Field.V)))}
    lq = lap(q, None, homogeneous=True)
    expect_u = dt * q["u"] + dt**2 * coeff * lq["u"]
    np.testing.assert_allclose(np.asarray(bn2(q)["u"]), np.asarray(expect_u),
                               rtol=1e-12)


def test_flux_velocity_converters_roundtrip():
    """R / R^-1 diagonal operators: flux = velocity * perpendicular face
    area; converting there and back is exact (reference:
    solutionsimple.cpp:90-119 convert2Velocity / convert2Flux)."""
    from petibm_jax.operators import (
        convert_to_flux, convert_to_velocity, make_m, make_mhat, make_r)

    cfg = cavity_config(8, 6)
    cfg["mesh"][1]["subDomains"] = [
        {"end": 0.5, "cells": 3, "stretchRatio": 0.8},
        {"end": 1.0, "cells": 3, "stretchRatio": 1.25}]
    mesh = StaggeredMesh(cfg)
    rng = np.random.default_rng(3)
    q = {"u": jnp.asarray(rng.standard_normal(mesh.shape(Field.U))),
         "v": jnp.asarray(rng.standard_normal(mesh.shape(Field.V)))}
    flux = convert_to_flux(mesh, q)
    # u-flux through an x-face = u * dy of the u-cell
    dy = mesh.bcast(Field.U, 1, mesh.dl(Field.U, 1))
    np.testing.assert_allclose(np.asarray(flux["u"]),
                               np.asarray(q["u"]) * dy, rtol=1e-14)
    back = convert_to_velocity(mesh, flux)
    for k in q:
        np.testing.assert_allclose(np.asarray(back[k]), np.asarray(q[k]),
                                   rtol=1e-14)
    # M = MHat * R^-1 identity (creatediagmatrix.cpp:180-207)
    m, mh, r = make_m(mesh), make_mhat(mesh), make_r(mesh)
    for k in m:
        np.testing.assert_allclose(np.asarray(m[k]),
                                   np.asarray(mh[k]) / np.asarray(r[k]),
                                   rtol=1e-14)


def test_laplacian_correction_matches_difference(tmp_path):
    """laplacian.correction(bc) must equal L(q, bc) - L(q, hom) exactly
    (the reference's LCorrection) on mixed Dirichlet/Neumann/convective/
    periodic faces — the O(surface) form replacing two full sweeps."""
    import numpy as np

    from test_mesh import cavity_config
    from petibm_jax.boundary import BoundarySet
    from petibm_jax.mesh import StaggeredMesh
    from petibm_jax.operators.stencil import VEL_NAMES, make_laplacian
    from petibm_jax.types import Field

    cfg = cavity_config(13, 11)
    cfg["flow"]["boundaryConditions"] = [
        {"location": "xMinus", "u": ["DIRICHLET", 1.0],
         "v": ["DIRICHLET", 0.0]},
        {"location": "xPlus", "u": ["CONVECTIVE", 1.0],
         "v": ["CONVECTIVE", 1.0]},
        {"location": "yMinus", "u": ["PERIODIC", 0.0],
         "v": ["PERIODIC", 0.0]},
        {"location": "yPlus", "u": ["PERIODIC", 0.0],
         "v": ["PERIODIC", 0.0]},
    ]
    mesh = StaggeredMesh(cfg)
    bcs = BoundarySet(mesh, cfg)
    lap = make_laplacian(mesh, bcs, jnp.float64)
    rng = np.random.default_rng(8)
    q = {VEL_NAMES[c]: jnp.asarray(
        rng.standard_normal(mesh.shape(Field(c)))) for c in range(2)}
    bcstate = bcs.init_state(q)
    # perturb a1 so the test isn't trivially zero
    bcstate = {k: {kk: vv + 0.37 if kk == "a1" else vv
                   for kk, vv in v.items()} for k, v in bcstate.items()}
    want = jax.tree_util.tree_map(
        lambda a, b: a - b, lap(q, bcstate), lap(q, None, homogeneous=True))
    got = lap.correction(bcstate)
    for c in range(2):
        np.testing.assert_allclose(np.asarray(got[VEL_NAMES[c]]),
                                   np.asarray(want[VEL_NAMES[c]]),
                                   atol=1e-12)
