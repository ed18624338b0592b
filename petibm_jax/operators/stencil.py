"""Gradient, divergence, and Laplacian as fused stencil closures.

Reference math:
  - gradient  (src/operators/creategradient.cpp:36-135): per velocity
    component c, ``(G p)_c(i) = (p(i+1) - p(i)) / dL_c(i)`` along c
    (normalize=False as the apps use, navierstokes.cpp:330).
  - divergence (src/operators/createdivergence.cpp:103-246): per pressure
    cell, sum over directions of face-area-weighted velocity differences
    ``area_d * (u_d(i) - u_d(i-1))`` — ghost (boundary) columns folded via
    the a0/a1 ghost relation (normalize=False, navierstokes.cpp:326).
  - Laplacian (src/operators/createlaplacian.cpp:108-162): per velocity
    point, sum over directions of
    ``(f(+1)-f)/ (dpos*dlself) + (f(-1)-f)/(dneg*dlself)``.

Each closure takes the interior field array(s) plus the dynamic BC state and
returns a same-layout array; ghost handling goes through
``BoundarySet.extend`` so the homogeneous (a0-folded matrix action) and
inhomogeneous (+ a1 correction, the reference's *Correction MatShells)
variants come from one code path.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..boundary import BoundarySet
from ..mesh import StaggeredMesh
from ..types import Field

VEL_NAMES = ("u", "v", "w")


def _axslice(arr, axis: int, start: int, size: int):
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(start, start + size)
    return arr[tuple(idx)]


def make_gradient(mesh: StaggeredMesh, dtype=jnp.float32):
    """p -> velocity-space gradient closure (entries ±1/dL)."""
    inv_dl = []
    for c in range(mesh.dim):
        arr = 1.0 / mesh.dl(Field(c), c)
        inv_dl.append(jnp.asarray(mesh.bcast(Field(c), c, arr), dtype=dtype))

    def gradient(p):
        out = {}
        for c in range(mesh.dim):
            axis = mesh.axis_of(c)
            if mesh.periodic[c]:
                # the appended max-face point wraps to p(0)
                # (reference: getNaturalIndex periodic wraparound,
                # cartesianmesh.cpp:592-676)
                lo = p
                hi = jnp.concatenate(
                    [_axslice(p, axis, 1, p.shape[axis] - 1),
                     _axslice(p, axis, 0, 1)], axis=axis)
                diff = hi - lo
            else:
                n = p.shape[axis]
                diff = _axslice(p, axis, 1, n - 1) - _axslice(p, axis, 0, n - 1)
            out[VEL_NAMES[c]] = diff * inv_dl[c]
        return out

    return gradient


def make_flux_area_arrays(mesh: StaggeredMesh, dtype=jnp.float32):
    """Face areas per direction, broadcast over the pressure shape: the
    product of the pressure cell widths in the other directions
    (reference: createdivergence.cpp:140-152; unit width in 2D)."""
    areas = []
    for c in range(mesh.dim):
        area = np.ones([1] * mesh.dim)
        for d in range(mesh.dim):
            if d == c:
                continue
            area = area * mesh.bcast(Field.P, d, mesh.dl(Field.P, d))
        areas.append(jnp.asarray(area, dtype=dtype))
    return areas


def make_divergence(mesh: StaggeredMesh, bcset: BoundarySet, dtype=jnp.float32):
    """velocity -> pressure-space divergence closure.

    ``divergence(q, bcstate)`` reproduces the reference's ``D + DCorrection``
    action; ``divergence(q, None, homogeneous=True)`` reproduces bare ``D``
    (used inside the Poisson operator where the input is a velocity-space
    increment whose ghosts obey the homogeneous relation).
    """
    areas = make_flux_area_arrays(mesh, dtype)

    def divergence(q, bcstate, homogeneous: bool = False):
        out = None
        for c in range(mesh.dim):
            axis = mesh.axis_of(c)
            ext = bcset.extend(q[VEL_NAMES[c]], c, bcstate,
                               homogeneous=homogeneous, dirs=(c,))
            n = mesh.n(Field.P, c)
            # cell i faces: positive = u(i) -> ext index i+1,
            # negative = u(i-1) -> ext index i
            flux = (_axslice(ext, axis, 1, n) - _axslice(ext, axis, 0, n))
            term = flux * areas[c]
            out = term if out is None else out + term
        return out

    return divergence


def make_laplacian(mesh: StaggeredMesh, bcset: BoundarySet, dtype=jnp.float32):
    """velocity -> velocity Laplacian closure (one sub-closure per component).

    ``laplacian(q, bcstate)`` = reference ``L + LCorrection`` action;
    ``homogeneous=True`` = bare ``L`` (BC a0 folded, a1 dropped) — the matrix
    the velocity implicit operator and Bn are built from.
    """
    cneg = {}
    cpos = {}
    for c in range(mesh.dim):
        cneg[c] = []
        cpos[c] = []
        for d in range(mesh.dim):
            line = mesh.lines[Field(c)][d]
            dself = line.interior_dl
            cn = 1.0 / (line.dneg() * dself)
            cp = 1.0 / (line.dpos() * dself)
            cneg[c].append(jnp.asarray(mesh.bcast(Field(c), d, cn), dtype=dtype))
            cpos[c].append(jnp.asarray(mesh.bcast(Field(c), d, cp), dtype=dtype))

    def component(c, f, bcstate, homogeneous=False):
        out = None
        for d in range(mesh.dim):
            axis = mesh.axis_of(d)
            ext = bcset.extend(f, c, bcstate, homogeneous=homogeneous, dirs=(d,))
            n = f.shape[axis]
            lo = _axslice(ext, axis, 0, n)
            hi = _axslice(ext, axis, 2, n)
            term = cneg[c][d] * (lo - f) + cpos[c][d] * (hi - f)
            out = term if out is None else out + term
        return out

    def laplacian(q, bcstate, homogeneous: bool = False):
        return {VEL_NAMES[c]: component(c, q[VEL_NAMES[c]], bcstate, homogeneous)
                for c in range(mesh.dim)}

    def correction(bcstate):
        """The a1 (inhomogeneous) part alone: L(q, bc) - L(q, hom) — the
        reference's LCorrection MatShell action (createlaplacian.cpp).
        Ghosts obey a0*target + a1 with a1 independent of q, so the
        correction is a boundary-adjacent surface field: cedge * a1 per
        non-periodic face.  O(surface) instead of the two extra
        full-grid sweeps the difference form costs (the round-5 3D RHS
        hotspot — see _rhs_velocity)."""
        out = {}
        for c in range(mesh.dim):
            shape = mesh.shape(Field(c))
            corr = jnp.zeros(shape, dtype)
            for d in range(mesh.dim):
                if mesh.periodic[d]:
                    continue
                axis = mesh.axis_of(d)
                for side, cvecs in ((0, cneg), (1, cpos)):
                    spec_key = bcset.specs[(c, 2 * d + side)].key
                    a1 = bcstate[spec_key]["a1"]
                    cvec = cvecs[c][d]
                    pos = 0 if side == 0 else shape[axis] - 1
                    cedge = _axslice(cvec, axis,
                                     0 if side == 0 else
                                     cvec.shape[axis] - 1, 1)
                    idx = [slice(None)] * len(shape)
                    idx[axis] = slice(pos, pos + 1)
                    corr = corr.at[tuple(idx)].add(
                        cedge * jnp.expand_dims(a1, axis).astype(dtype))
            out[VEL_NAMES[c]] = corr
        return out

    laplacian.correction = correction
    return laplacian
