"""Library-API example: hand-rolled projection loop for the 2D lid-driven
cavity, composing the framework's public pieces directly (mirrors the
reference's examples/api_examples/liddrivencavity2d/main.cpp:30-381 intent:
the library is composable without the CLI apps).

Run:  PYTHONPATH=<repo> python examples/api_examples/liddrivencavity2d.py
"""

import jax
import jax.numpy as jnp

from petibm_jax import BoundarySet, StaggeredMesh
from petibm_jax.ics import initial_fields
from petibm_jax.linalg import bicgstab, cg
from petibm_jax.linalg.mg import PoissonMG
from petibm_jax.operators import (
    make_bn,
    make_convection,
    make_divergence,
    make_gradient,
    make_laplacian,
)
from petibm_jax.timeintegration import create_time_integration

tmap = jax.tree_util.tree_map

config = {
    "mesh": [
        {"direction": "x", "start": 0.0,
         "subDomains": [{"end": 1.0, "cells": 32, "stretchRatio": 1.0}]},
        {"direction": "y", "start": 0.0,
         "subDomains": [{"end": 1.0, "cells": 32, "stretchRatio": 1.0}]},
    ],
    "flow": {
        "nu": 0.01,
        "initialVelocity": [0.0, 0.0],
        "boundaryConditions": [
            {"location": "xMinus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
            {"location": "xPlus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
            {"location": "yMinus", "u": ["DIRICHLET", 0.0], "v": ["DIRICHLET", 0.0]},
            {"location": "yPlus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
        ],
    },
}

dt, nu, nt = 0.01, 0.01, 500

mesh = StaggeredMesh(config)
print(mesh.info())
bc = BoundarySet(mesh, config)
conv_ti = create_time_integration("convection", config)
diff_ti = create_time_integration("diffusion", config)

dtype = jnp.float32
grad = make_gradient(mesh, dtype)
div = make_divergence(mesh, bc, dtype)
lap = make_laplacian(mesh, bc, dtype)
convect = make_convection(mesh, bc, dtype)
bn = make_bn(lap, dt, diff_ti.implicit_coeff * nu, 1)
mg = PoissonMG(mesh.dxp, mesh.periodic, dtype=dtype, scale=dt)

fields0 = initial_fields(config, mesh)
q = {k: jnp.asarray(v, dtype) for k, v in fields0.items() if k != "p"}
p = jnp.asarray(fields0["p"], dtype)
bcstate = bc.init_state(q, dtype)


def A_mom(u):
    lu = lap(u, None, homogeneous=True)
    return tmap(lambda a, b: a / dt - diff_ti.implicit_coeff * nu * b, u, lu)


def negA_p(phi):
    return -div(bn(grad(phi)), None, homogeneous=True)


@jax.jit
def step(q, p, bcstate, conv, diff):
    rhs = tmap(lambda u, g: u / dt - g, q, grad(p))
    conv = (tmap(lambda x: -x, convect(q, bcstate)),) + conv[:-1]
    for c, h in zip(conv_ti.explicit_coeffs, conv):
        rhs = tmap(lambda r, x: r + c * x, rhs, h)
    diff = (tmap(lambda x: nu * x, lap(q, bcstate)),) + diff[:-1]
    for c, h in zip(diff_ti.explicit_coeffs, diff):
        rhs = tmap(lambda r, x: r + c * x, rhs, h)
    bcstate = bc.update_eqs(bcstate, q, dt)
    corr = tmap(lambda a, b: nu * (a - b), lap(q, bcstate),
                lap(q, None, homogeneous=True))
    rhs = tmap(lambda r, x: r + diff_ti.implicit_coeff * x, rhs, corr)
    ustar = bicgstab(A_mom, rhs, q, atol=1e-6).x
    rhs2 = div(ustar, bcstate)
    rhs2 = rhs2 - jnp.mean(rhs2)
    dP = cg(negA_p, -rhs2, jnp.zeros_like(p), M=mg.preconditioner(),
            atol=1e-6).x
    dP = dP - jnp.mean(dP)
    q = tmap(lambda u, g: u - g, ustar, bn(grad(dP)))
    p = p + dP
    bcstate = bc.update_ghost_values(bcstate, q)
    return q, p, bcstate, conv, diff


conv = tuple(tmap(jnp.zeros_like, q) for _ in range(conv_ti.n_explicit))
diff = tuple(tmap(jnp.zeros_like, q) for _ in range(diff_ti.n_explicit))
for it in range(1, nt + 1):
    q, p, bcstate, conv, diff = step(q, p, bcstate, conv, diff)
    if it % 100 == 0:
        print(f"step {it}: max|u| = {float(jnp.max(jnp.abs(q['u']))):.4f}")
print("done")
