"""Interpolation (E) and spreading (H) via regularized delta windows.

Reference (src/operators/createdelta.cpp:28-208 + decoupledibpm.cpp:149-216):
the delta operator is a sparse matrix with one row per (Lagrangian point,
velocity component) whose columns are the component's grid points within
±kernel half-width of the point's pressure cell, valued with the
tensor-product kernel.  E = Delta * diag(R*MHat) (volume-weighted
interpolation); H = Delta^T (spreading).

Realization: the tensor-product structure is kept *separated*
as per-direction banded factor matrices S_d of shape (nPts, n_d) — each row
holds the 1D kernel weights of one Lagrangian point scattered to its ±w
gridline window (built by one-hot comparison, no scatter op).  Then

  interpolation (2D):  E u = sum_x ( (S_y^vol @ u) * S_x^vol )
  spreading (2D):      H f = (S_y^delta * f)^T @ S_x^delta

— dense banded matmuls instead of XLA gather/scatter (whether a
gather/scatter form is faster on the GPU is not measured yet).  The
factors are recomputed *inside jit* from the (possibly traced) body
coordinates, so prescribed-kinematics bodies re-derive their stencils every
step with static shapes and zero recompilation (SURVEY.md §7 hard parts).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

#: every product of the delta operator runs in full precision: at the
#: matmul default an f32 product runs in TF32 on a GPU with tensor cores,
#: and the ~1e-3 error it puts into E and H is not corrected by any
#: residual check (the no-slip and force solves take E/H as exact).  These
#: matmuls are small (points x gridlines), so the cost is negligible.
_EXACT = jax.lax.Precision.HIGHEST


def exact_dot(a, b):
    """``a @ b`` in full precision, for the small dense force-space
    products (EBNH and Schur inverses) whose results the force solves'
    convergence checks rely on."""
    return jnp.dot(a, b, precision=_EXACT)

from ..mesh import StaggeredMesh
from ..types import Field
from .delta import KERNELS

VEL_NAMES = ("u", "v", "w")


class DeltaOp:
    #: True for the gather/scatter large-body engine (WindowedDeltaOp);
    #: consumers that need dense factor matrices (the decoupled solver's
    #: direct EBNH blocks) check this
    windowed = False

    def __init__(self, mesh: StaggeredMesh, kernel: str = "ROMA_ET_AL_1999",
                 dtype=jnp.float32):
        self.mesh = mesh
        self.dim = mesh.dim
        self.kernel, self.half = KERNELS[kernel]
        self.K = 2 * self.half + 1
        self.dtype = dtype
        # static per-direction data
        self.vertex = [jnp.asarray(mesh.coord(Field.VERTEX, d), dtype)
                       for d in range(self.dim)]
        self.L = [float(mesh.max[d] - mesh.min[d]) for d in range(self.dim)]
        self.periodic = mesh.periodic
        # per-component, per-direction interior coords / widths / sizes
        self.coord = {c: [jnp.asarray(mesh.coord(Field(c), d), dtype)
                          for d in range(self.dim)] for c in range(self.dim)}
        self.dl = {c: [jnp.asarray(mesh.dl(Field(c), d), dtype)
                       for d in range(self.dim)] for c in range(self.dim)}
        self.n = {c: [mesh.n(Field(c), d) for d in range(self.dim)]
                  for c in range(self.dim)}
        # u-grid dl per direction for the kernel widths
        # (reference: createdelta.cpp:69-77)
        self.width_dl = [jnp.asarray(mesh.dl(Field.U, d), dtype)
                         for d in range(self.dim)]

    # ------------------------------------------------------------------
    def cell_index(self, X):
        """Owning pressure-cell index per point per direction (traced;
        reference: singlebodypoints.cpp:95-120)."""
        cols = []
        for d in range(self.dim):
            cols.append(jnp.searchsorted(self.vertex[d], X[:, d],
                                         side="right") - 1)
        return jnp.stack(cols, axis=1)

    def windows(self, X):
        """Banded factor matrices for all components.

        Returns {c: {"sd": [per-dir (N, n_d)], "sv": [per-dir (N, n_d)]}}
        where sd carries the 1D delta weights and sv additionally the
        component cell widths (prod over dirs of sv = delta * cell volume —
        the E scaling, reference: decoupledibpm.cpp:181-183).
        """
        X = jnp.asarray(X, self.dtype)
        npts = X.shape[0]
        ijk = self.cell_index(X)
        offsets = jnp.arange(-self.half, self.half + 1)
        # kernel widths from the u-grid cell of the first body point
        # (reference: createdelta.cpp:69-77 — assumes a uniform region)
        widths = [self.width_dl[d][ijk[0, d]] for d in range(self.dim)]

        out = {}
        for c in range(self.dim):
            sd_d, sv_d = [], []
            for d in range(self.dim):
                n = self.n[c][d]
                s = ijk[:, d:d + 1] + offsets[None, :]  # (N, K)
                if self.periodic[d]:
                    idx = jnp.mod(s, n)
                    shift = jnp.floor_divide(s, n).astype(self.dtype) * self.L[d]
                    x = self.coord[c][d][idx] + shift
                    valid = jnp.ones(s.shape, dtype=bool)
                else:
                    valid = (s >= 0) & (s < n)
                    idx = jnp.clip(s, 0, n - 1)
                    x = self.coord[c][d][idx]
                w = self.kernel(X[:, d:d + 1] - x, widths[d])
                w = jnp.where(valid, w, 0.0)
                # scatter the K window weights into banded rows by one-hot
                # comparison — a (N, K, n) mask reduction, no scatter op
                onehot = (idx[:, :, None]
                          == jnp.arange(n)[None, None, :]).astype(self.dtype)
                sd = jnp.einsum("pk,pkn->pn", w, onehot, precision=_EXACT)
                sd_d.append(sd)
                sv_d.append(sd * self.dl[c][d][None, :])
            out[c] = {"sd": sd_d, "sv": sv_d}
        return out

    # ------------------------------------------------------------------
    def interpolate(self, q, win):
        """E u: volume-weighted interpolation onto the Lagrangian points;
        returns (N, dim)."""
        cols = []
        for c in range(self.dim):
            w = win[c]
            arr = q[VEL_NAMES[c]]
            if self.dim == 2:
                sy, sx = w["sv"][1], w["sv"][0]
                t = jnp.einsum("py,yx->px", sy, arr,
                               preferred_element_type=self.dtype,
                               precision=_EXACT)
                cols.append(jnp.sum(t * sx, axis=1))
            else:
                sz, sy, sx = w["sv"][2], w["sv"][1], w["sv"][0]
                t = jnp.einsum("pz,zyx->pyx", sz, arr,
                               preferred_element_type=self.dtype,
                               precision=_EXACT)
                t = jnp.einsum("py,pyx->px", sy, t,
                               preferred_element_type=self.dtype,
                               precision=_EXACT)
                cols.append(jnp.sum(t * sx, axis=1))
        return jnp.stack(cols, axis=1)

    def spread(self, f, win):
        """H f = Delta^T f: spread the Lagrangian forces onto the grids;
        f is (N, dim), returns a velocity-space dict."""
        out = {}
        for c in range(self.dim):
            w = win[c]
            fc = f[:, c]
            if self.dim == 2:
                sy, sx = w["sd"][1], w["sd"][0]
                out[VEL_NAMES[c]] = jnp.einsum(
                    "py,px->yx", sy * fc[:, None], sx,
                    preferred_element_type=self.dtype,
                    precision=_EXACT)
            else:
                sz, sy, sx = w["sd"][2], w["sd"][1], w["sd"][0]
                t = jnp.einsum("pz,py->pzy", sz * fc[:, None], sy,
                               preferred_element_type=self.dtype,
                               precision=_EXACT)
                out[VEL_NAMES[c]] = jnp.einsum(
                    "pzy,px->zyx", t, sx, preferred_element_type=self.dtype,
                    precision=_EXACT)
        return out


class WindowedDeltaOp(DeltaOp):
    """Large-body delta engine: (N, K) banded windows + chunked matmuls.

    The factor-matrix engine above materializes (N, n_d) dense factors per
    component per direction and builds them with an O(N*K*n) one-hot
    reduction — gigabytes and a dominant build cost at the 10^5-10^6-point
    3D bodies the reference's windowed sparse Delta handles natively
    (createdelta.cpp:34-169).  This engine keeps exactly the K weights per
    direction per point (same ``sd``/``sv`` keys, shape (N, K), plus the
    ``idx`` gridline indices), so window memory and build cost are
    O(N*K): interpolation gathers the K^dim window values; spreading
    scatter-adds them.  The per-point reductions the solvers share (e.g.
    diag(E B1 H) via sum(sd*sv, axis=1)) are identical in both layouts
    because the (N, n_d) rows hold the same K nonzeros.

    Consumers needing dense per-grid-axis factors (the decoupled solver's
    direct dense EBNH blocks) must fall back to matrix-free Krylov —
    flagged by ``windowed = True`` (at such N a dense (N, N) block is
    infeasible anyway).
    """

    windowed = True

    def windows(self, X):
        X = jnp.asarray(X, self.dtype)
        ijk = self.cell_index(X)
        offsets = jnp.arange(-self.half, self.half + 1)
        widths = [self.width_dl[d][ijk[0, d]] for d in range(self.dim)]

        out = {}
        for c in range(self.dim):
            idx_d, sd_d, sv_d = [], [], []
            for d in range(self.dim):
                n = self.n[c][d]
                s = ijk[:, d:d + 1] + offsets[None, :]  # (N, K)
                if self.periodic[d]:
                    idx = jnp.mod(s, n)
                    shift = (jnp.floor_divide(s, n).astype(self.dtype)
                             * self.L[d])
                    x = self.coord[c][d][idx] + shift
                    valid = jnp.ones(s.shape, dtype=bool)
                else:
                    valid = (s >= 0) & (s < n)
                    idx = jnp.clip(s, 0, n - 1)
                    x = self.coord[c][d][idx]
                w = self.kernel(X[:, d:d + 1] - x, widths[d])
                w = jnp.where(valid, w, 0.0)
                idx_d.append(idx)
                sd_d.append(w)
                sv_d.append(w * self.dl[c][d][idx])
            out[c] = {"idx": idx_d, "sd": sd_d, "sv": sv_d}
        return out

    #: target bytes for a chunk's (B, plane) matmul intermediate — keeps
    #: the chunked expansion's footprint bounded regardless of body size
    _chunk_budget = 128 * 1024 * 1024

    def _chunk_size(self, c) -> int:
        plane = 1
        for d in range(self.dim - 1):  # all but the last-contracted dir
            plane *= self.n[c][d]
        itemsize = jnp.dtype(self.dtype).itemsize
        b = self._chunk_budget // max(1, plane * itemsize)
        # round down to a power of two within [8, 8192]; the floor stays
        # tiny so huge in-plane grids (plane ~ MBs) cannot overshoot the
        # budget through the clamp
        b = min(8192, 1 << int(b).bit_length() >> 1) if b >= 1 else 1
        return max(8, b)

    def _expand(self, c, d, idx, wt):
        """(B, K) banded rows -> (B, n_d) dense factor rows (the one-hot
        mask+multiply+sum fuses in XLA; nothing (B, K, n) materializes)."""
        n = self.n[c][d]
        onehot = (idx[:, :, None]
                  == jnp.arange(n)[None, None, :]).astype(self.dtype)
        return jnp.einsum("pk,pkn->pn", wt, onehot, precision=_EXACT)

    def _chunked(self, win, c, key):
        """Yield-style helper: (padded N, chunk size, stacked (nc, B, K)
        idx/weights) for lax.scan over chunks of points."""
        idx = win[c]["idx"]
        wt = win[c][key]
        N = idx[0].shape[0]
        B = self._chunk_size(c)
        nc = -(-N // B)
        pad = nc * B - N
        idx_s = [jnp.pad(i, ((0, pad), (0, 0))).reshape(nc, B, self.K)
                 for i in idx]
        wt_s = [jnp.pad(w, ((0, pad), (0, 0))).reshape(nc, B, self.K)
                for w in wt]  # padded rows have zero weights -> no effect
        return N, nc, idx_s, wt_s

    def interpolate(self, q, win):
        """Same separable-matmul algebra as the factor engine, applied per
        chunk of points with factors expanded on the fly — O(N*K) window
        state, dense matmuls, bounded (B, plane) intermediates."""
        cols = []
        for c in range(self.dim):
            arr = q[VEL_NAMES[c]]
            N, nc, idx_s, wt_s = self._chunked(win, c, "sv")

            def body(carry, chunk, c=c, arr=arr):
                idx, wt = chunk
                s = [self._expand(c, d, idx[d], wt[d])
                     for d in range(self.dim)]
                if self.dim == 2:
                    t = jnp.einsum("py,yx->px", s[1], arr,
                                   preferred_element_type=self.dtype,
                                   precision=_EXACT)
                    out = jnp.sum(t * s[0], axis=1)
                else:
                    t = jnp.einsum("pz,zyx->pyx", s[2], arr,
                                   preferred_element_type=self.dtype,
                                   precision=_EXACT)
                    t = jnp.einsum("py,pyx->px", s[1], t,
                                   preferred_element_type=self.dtype,
                                   precision=_EXACT)
                    out = jnp.sum(t * s[0], axis=1)
                return carry, out

            _, out = jax.lax.scan(body, 0, (idx_s, wt_s))
            cols.append(out.reshape(-1)[:N])
        return jnp.stack(cols, axis=1)

    def spread(self, f, win):
        out = {}
        for c in range(self.dim):
            N, nc, idx_s, wt_s = self._chunked(win, c, "sd")
            B = idx_s[0].shape[1]
            pad = nc * B - N
            fc = jnp.pad(f[:, c], (0, pad)).reshape(nc, B)
            shape = tuple(self.n[c][d] for d in reversed(range(self.dim)))

            def body(acc, chunk, c=c):
                idx, wt, fch = chunk
                s = [self._expand(c, d, idx[d], wt[d])
                     for d in range(self.dim)]
                if self.dim == 2:
                    g = jnp.einsum("py,px->yx", s[1] * fch[:, None], s[0],
                                   preferred_element_type=self.dtype,
                                   precision=_EXACT)
                else:
                    t = jnp.einsum("pz,py->pzy", s[2] * fch[:, None], s[1],
                                   preferred_element_type=self.dtype,
                                   precision=_EXACT)
                    g = jnp.einsum("pzy,px->zyx", t, s[0],
                                   preferred_element_type=self.dtype,
                                   precision=_EXACT)
                return acc + g, None

            acc, _ = jax.lax.scan(
                body, jnp.zeros(shape, self.dtype), (idx_s, wt_s, fc))
            out[VEL_NAMES[c]] = acc
        return out


def dense_ebnh_blocks(win, dim: int, dt: float, dtype):
    """Per-component dense (N, N) blocks of E B1 H = dt * E H for
    factor-engine windows: prod over directions of (S_vol,d @ S_delta,d^T)
    — symmetric (the volume weights attach to the contracted grid index).
    Shared by the decoupled solver's direct force solve and the coupled
    IBPM's force-block preconditioner (reference assembles the same
    product sparsely via SpGEMM, decoupledibpm.cpp:171-216)."""
    mats = []
    for c in range(dim):
        m = None
        for d in range(dim):
            a = jnp.einsum("pn,qn->pq", win[c]["sv"][d], win[c]["sd"][d],
                           preferred_element_type=dtype, precision=_EXACT)
            m = a if m is None else m * a
        mats.append(dt * m)
    return mats


#: factor-matrix engine up to this many Lagrangian points; windowed above
#: (the (N, n_d) factors and their O(N*K*n) build dominate beyond it)
WINDOWED_THRESHOLD = 16384


def make_delta_op(mesh: StaggeredMesh, kernel: str = "ROMA_ET_AL_1999",
                  dtype=jnp.float32, n_pts: int | None = None,
                  engine: str = "auto") -> DeltaOp:
    """Pick the delta engine: ``auto`` uses the dense factor-matrix path for
    small bodies and the windowed gather/scatter path above
    WINDOWED_THRESHOLD points; ``factor`` / ``windowed`` force one."""
    if engine == "auto":
        engine = ("windowed" if n_pts is not None
                  and n_pts > WINDOWED_THRESHOLD else "factor")
    if engine == "windowed":
        return WindowedDeltaOp(mesh, kernel, dtype)
    if engine == "factor":
        return DeltaOp(mesh, kernel, dtype)
    raise ValueError(f"unknown delta engine {engine!r} "
                     "(want auto|factor|windowed)")
