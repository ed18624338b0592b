"""Geometric multigrid for the pressure Poisson system.

Replaces the reference's GAMG / AmgX algebraic multigrid
(reference: examples' poisson_solver.info `-pc_type gamg`;
linsolveramgx.cpp).  The reference needs AMG because PETSc treats the
matrix as unstructured; here the mesh is owned by the framework, so
*geometric* MG on the cell-centered pressure grid is the idiomatic and
faster choice (SURVEY.md §7).

Operator hierarchy: the finest operator is the (negated) D*B1*G
finite-volume Laplacian — face coefficient area/dist, zero flux at
non-periodic domain boundaries (the a0=0 folding of normal-velocity
increments), wraparound where periodic.  Coarser levels rediscretize the
same FV formula on 2x-aggregated cell widths (pairwise sums; odd tails
keep a lone cell).  Restriction is the conservative child-sum (residuals
are integrated fluxes); prolongation is piecewise-constant injection (its
transpose).  Smoother: alternating-direction damped line-Jacobi —
batched tridiagonal solves per direction (robust on stretched /
anisotropic grids), by parallel cyclic reduction (tridiag.py) or
``lax.linalg.tridiagonal_solve``, whichever the backend runs faster.

Used as a V-cycle preconditioner inside CG (MGCG), keeping the outer
Krylov semantics (tolerances, iteration counts) identical to the
reference's `-ksp_type cg -pc_type gamg` configuration.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def _axslice(arr, axis: int, start: int, size: int):
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(start, start + size)
    return arr[tuple(idx)]


@dataclasses.dataclass
class _Level:
    shape: tuple  # (z, y, x) ordering
    # Separable operator factors, per direction d (x, y[, z]):
    #   c1d[d]: (n_d+1,) scaled face coefficients (scale/dist); entry k
    #           couples cells k-1 and k; 0 at non-periodic walls, the wrap
    #           coefficient at entries 0 and n for periodic directions
    #   w1d[d]: (n_d,) cell widths (the perpendicular-area factors)
    # The dense DIA coefficient of a direction-d face is
    # c1d[d] x prod_{d' != d} w1d[d'].  Keeping the factors 1D and forming
    # products lazily lets XLA fuse the broadcasts into the stencil loops,
    # so applies and smoother sweeps stream only phi and out from device
    # memory instead of 2*dim+2 dense coefficient arrays (a ~3x traffic
    # cut on 3D grids).
    c1d: list
    w1d: list
    periodic: list  # static per-direction wrap flags

    def _bshape(self, d: int, n: int) -> list:
        s = [1] * len(self.shape)
        s[len(self.shape) - 1 - d] = n
        return s

    def area(self, d: int):
        """Perpendicular area: broadcastable product of the other
        directions' cell widths (constant along direction d)."""
        out = None
        for dp, w in enumerate(self.w1d):
            if dp == d:
                continue
            t = w.reshape(self._bshape(dp, w.shape[0]))
            out = t if out is None else out * t
        if out is None:  # 1D operator
            out = jnp.ones((1,) * len(self.shape), self.c1d[0].dtype)
        return out

    def diag_full(self):
        """Row diagonal (positive sum of face coefficients), broadcast to
        the level shape."""
        out = None
        for d, c in enumerate(self.c1d):
            a = (c[:-1] + c[1:]).reshape(self._bshape(d, c.shape[0] - 1))
            t = a * self.area(d)
            out = t if out is None else out + t
        return jnp.broadcast_to(out, self.shape)


class PoissonMG:
    """V-cycle preconditioner for the negated pressure Poisson operator."""

    def __init__(self, dxp: list[np.ndarray], periodic: list[bool],
                 dtype=jnp.float32, scale: float = 1.0, pre: int = 2,
                 post: int = 2, omega: float = 1.0, coarse_sweeps: int = 10,
                 min_size: int = 3, consolidate_below: int = 4096):
        """``dxp``: pressure cell widths per direction (x, y[, z]);
        ``scale``: dt factor of B1 (kept for operator parity; CG is
        invariant to preconditioner scaling); ``consolidate_below``: under
        sharding (see :meth:`set_mesh`), levels with at most this many
        cells run fully replicated (redundant coarse solve) instead of
        sharded — the distributed-MG coarse-level fix (a 6x6 level sharded
        over 8 devices is pure halo-exchange latency; the reference
        delegates the same problem to AmgX's rank consolidation,
        linsolveramgx.cpp:54-126)."""
        self.dim = len(dxp)
        self.dtype = dtype
        self.pre, self.post = pre, post
        self.omega = omega
        self.coarse_sweeps = coarse_sweeps
        self.consolidate_below = int(consolidate_below)
        self.sharding_mesh = None  # set_mesh() activates consolidation
        # line-smoother tridiagonal backend: lax.linalg.tridiagonal_solve
        # (LAPACK on the CPU, cuSPARSE on the GPU) beats the jnp PCR on
        # both backends.  H100 SXM at a 400 W limit, f32, us per batched
        # solve (scripts/bench_spmv.py): 450 lines of 450, 19.3 vs 32.1;
        # 256 of 256, 10.0 vs 22.4; one whole 2D sweep at 450^2, 68 vs
        # 122; 3D at 160x130x130, 866 vs 1790.  PCR stays for the dtypes
        # tridiagonal_solve lacks (bf16/f16 V-cycles) and as the tests'
        # second implementation.
        self.use_pcr = False

        # finest-level 1D data: cell widths and face inverse-distances
        widths = [np.asarray(d, np.float64) for d in dxp]
        inv_dist = []
        for d, w in enumerate(widths):
            c = np.zeros(len(w) + 1)
            c[1:-1] = 1.0 / (0.5 * (w[:-1] + w[1:]))
            if periodic[d]:
                c[0] = c[-1] = 1.0 / (0.5 * (w[0] + w[-1]))
            inv_dist.append(c)

        # Galerkin (RAP) hierarchy with child-sum restriction and injection
        # prolongation: for this separable FV operator RAP stays separable —
        # coarse interface coefficient = *fine* 1/dist at the interface face
        # times the *coarse* perpendicular area (internal fine couplings
        # cancel in the RAP diagonal).
        self.levels: list[_Level] = []
        while True:
            self.levels.append(self._make_level(widths, inv_dist, periodic, scale))
            if min(len(w) for w in widths) <= min_size or len(self.levels) > 12:
                break
            new_w, new_c = [], []
            for w, c in zip(widths, inv_dist):
                n = len(w)
                nc = (n + 1) // 2
                wc = np.zeros(nc)
                wc[: n // 2] = w[0:2 * (n // 2):2] + w[1:2 * (n // 2):2]
                if n % 2:
                    wc[-1] = w[-1]
                cc = c[np.minimum(2 * np.arange(nc + 1), n)]
                new_w.append(wc)
                new_c.append(cc)
            widths, inv_dist = new_w, new_c

    def _make_level(self, widths, inv_dist, periodic, scale) -> _Level:
        return _Level(
            shape=tuple(reversed([len(w) for w in widths])),
            c1d=[jnp.asarray(scale * c, self.dtype) for c in inv_dist],
            w1d=[jnp.asarray(w, self.dtype) for w in widths],
            periodic=list(periodic))

    # ------------------------------------------------------------------
    def _coupling(self, lvl: int, phi, d: int):
        """Direction-d off-diagonal action: sum of face-coeff * neighbor
        (positive sign), including the periodic wrap.  The 1D face factors
        multiply the shifted phi; the (constant-along-d) perpendicular
        area scales the whole term once at the end, so XLA streams no
        dense coefficient arrays."""
        level = self.levels[lvl]
        axis = self.dim - 1 - d
        n = phi.shape[axis]
        c = level.c1d[d].reshape(level._bshape(d, n + 1))
        lo = _axslice(phi, axis, 0, n - 1)
        hi = _axslice(phi, axis, 1, n - 1)
        cin = _axslice(c, axis, 1, n - 1)
        # interior faces couple (k-1, k): row k gets c(k)*phi(k-1),
        # row k-1 gets c(k)*phi(k)
        pad = [(0, 0)] * phi.ndim
        pad[axis] = (1, 0)
        out = jnp.pad(cin * lo, pad)
        pad[axis] = (0, 1)
        out = out + jnp.pad(cin * hi, pad)
        if level.periodic[d]:
            c0 = _axslice(c, axis, 0, 1)
            first = _axslice(phi, axis, 0, 1)
            last = _axslice(phi, axis, n - 1, 1)
            pad_lo = [(0, 0)] * phi.ndim
            pad_lo[axis] = (0, n - 1)
            pad_hi = [(0, 0)] * phi.ndim
            pad_hi[axis] = (n - 1, 0)
            out = out + jnp.pad(c0 * last, pad_lo) + jnp.pad(c0 * first, pad_hi)
        return level.area(d) * out

    def apply_op(self, lvl: int, phi):
        """The negated FV Laplacian at one level: positive semidefinite."""
        out = self.levels[lvl].diag_full() * phi
        for d in range(self.dim):
            out = out - self._coupling(lvl, phi, d)
        return out

    def smooth(self, lvl: int, phi, rhs, sweeps: int):
        """Alternating-direction damped line-Jacobi: one sweep solves the
        tridiagonal line systems of each direction in turn (batched
        parallel cyclic reduction — log2(n) vectorized passes, see
        linalg/tridiag.py), which keeps MG robust on stretched/anisotropic
        grids where point smoothers fail (the SURVEY.md §7 'hard parts'
        anisotropy risk; the reference leans on GAMG/AmgX aggregation for
        the same reason)."""
        for _ in range(sweeps):
            for d in range(self.dim):
                phi = self._line_sweep(lvl, phi, rhs, d)
        return phi

    def _line_sweep(self, lvl: int, phi, rhs, d: int):
        from .tridiag import tridiag_solve_pcr

        level = self.levels[lvl]
        axis = self.dim - 1 - d
        n = phi.shape[axis]

        # off-line couplings (other directions + this direction's wrap) to RHS
        b = rhs
        for dp in range(self.dim):
            if dp != d:
                b = b + self._coupling(lvl, phi, dp)
        area = level.area(d)
        c = level.c1d[d].reshape(level._bshape(d, n + 1))
        if level.periodic[d]:
            c0 = _axslice(c, axis, 0, 1)
            first = _axslice(phi, axis, 0, 1)
            last = _axslice(phi, axis, n - 1, 1)
            pad_lo = [(0, 0)] * phi.ndim
            pad_lo[axis] = (0, n - 1)
            pad_hi = [(0, 0)] * phi.ndim
            pad_hi[axis] = (n - 1, 0)
            b = b + area * (jnp.pad(c0 * last, pad_lo)
                            + jnp.pad(c0 * first, pad_hi))

        # tridiagonal system along axis: diag = full diagonal, off = -c_in
        cin = _axslice(c, axis, 1, n - 1)
        pad = [(0, 0)] * phi.ndim
        pad[axis] = (1, 0)
        dl = -jnp.pad(cin, pad) * area  # dl[k] couples to k-1
        pad[axis] = (0, 1)
        du = -jnp.pad(cin, pad) * area  # du[k] couples to k+1
        diag = level.diag_full()
        dl = jnp.broadcast_to(dl, phi.shape)
        du = jnp.broadcast_to(du, phi.shape)

        # move the line axis last, batch-solve, move back
        def tolast(a):
            return jnp.moveaxis(a, axis, -1)

        if self.use_pcr or jnp.dtype(phi.dtype).itemsize < 4 or n < 3:
            # the pure-jnp PCR path is dtype-agnostic; tridiagonal_solve
            # supports only f32/f64, and on the GPU (cuSPARSE's batched
            # gtsv2) only lines of 3 or more points
            x = tridiag_solve_pcr(tolast(dl), tolast(diag), tolast(du),
                                  tolast(b))
        else:
            from jax.lax.linalg import tridiagonal_solve

            x = tridiagonal_solve(tolast(dl), tolast(diag), tolast(du),
                                  tolast(b)[..., None])[..., 0]
        phi_star = jnp.moveaxis(x, -1, axis)
        return phi + self.omega * (phi_star - phi)

    def restrict(self, lvl: int, r):
        """Conservative child-sum onto level lvl+1."""
        coarse_shape = self.levels[lvl + 1].shape
        out = r
        for d in range(self.dim):
            axis = self.dim - 1 - d
            n = out.shape[axis]
            nc = coarse_shape[axis]
            pad = [(0, 0)] * out.ndim
            pad[axis] = (0, 2 * nc - n)
            padded = jnp.pad(out, pad)
            new_shape = list(padded.shape)
            new_shape[axis] = nc
            new_shape.insert(axis + 1, 2)
            out = padded.reshape(new_shape).sum(axis=axis + 1)
        return out

    def prolong(self, lvl: int, e):
        """Piecewise-constant injection onto level lvl-1."""
        fine_shape = self.levels[lvl - 1].shape
        out = e
        for d in range(self.dim):
            axis = self.dim - 1 - d
            n = fine_shape[axis]
            out = jnp.repeat(out, 2, axis=axis)
            out = _axslice(out, axis, 0, n)
        return out

    def set_mesh(self, mesh) -> None:
        """Activate sharded execution: levels above ``consolidate_below``
        cells carry ("dy","dx") sharding constraints; levels at or below
        it are constrained fully replicated, so every device redundantly
        runs the tiny coarse grids with ONE all-gather at the
        consolidation boundary instead of halo exchanges on every sweep."""
        self.sharding_mesh = mesh

    def _constrain(self, lvl: int, x):
        if self.sharding_mesh is None:
            return x
        import math

        from jax.sharding import NamedSharding, PartitionSpec as P

        if math.prod(self.levels[lvl].shape) <= self.consolidate_below:
            spec = P()  # replicate: redundant coarse compute, no comms
        else:
            from ..parallel.dist import _leaf_spec

            spec = _leaf_spec(x, self.sharding_mesh)
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.sharding_mesh, spec))

    def vcycle(self, lvl: int, rhs):
        """One V-cycle solving (apply_op) e = rhs from a zero initial guess."""
        phi = jnp.zeros(self.levels[lvl].shape, self.dtype)
        if lvl == len(self.levels) - 1:
            return self.smooth(lvl, phi, rhs, self.coarse_sweeps)
        phi = self.smooth(lvl, phi, rhs, self.pre)
        r = rhs - self.apply_op(lvl, phi)
        ec = self.vcycle(lvl + 1, self._constrain(lvl + 1,
                                                  self.restrict(lvl, r)))
        phi = phi + self._constrain(lvl, self.prolong(lvl + 1, ec))
        return self.smooth(lvl, phi, rhs, self.post)

    def preconditioner(self, remove_mean: bool = True):
        """M(r) ~ A^-1 r via one V-cycle (for CG on the negated operator).

        ``remove_mean`` keeps the Krylov space orthogonal to the all-Neumann
        operator's constant nullspace: smoothers and the coarse solve inject
        an arbitrary constant which otherwise accumulates through the CG
        recurrences and (in f32) can stall convergence.  Disable for the
        pinned-pressure (nonsingular) variant.
        """
        if not remove_mean:
            return lambda r: self.vcycle(0, r)

        def M(r):
            out = self.vcycle(0, r - jnp.mean(r))
            return out - jnp.mean(out)

        return M
