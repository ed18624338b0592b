"""Direct fast-diagonalization solver for the pressure Poisson system.

Replaces the iterative CG + multigrid pressure solve (the reference's
``-ksp_type cg -pc_type gamg`` / AmgX path, navierstokes.cpp:566-580) for
BN order 1, where the operator -D B1 G is *exactly* a Kronecker sum of 1D
finite-volume operators:

    A  =  sum_d ( W_{d'!=d} (x) T_d ),      W_d = diag(cell widths),
                                            T_d = 1D FV Laplacian factor

(the same separable factorization ``linalg/mg.py`` stores as
``_Level.c1d/w1d`` and ``tests/test_mg.py`` verifies equals -D B1 G).

At setup, each direction's generalized symmetric eigenproblem

    T_d q = lambda W_d q     (host numpy, float64)

gives Q_d with Q_d^T W_d Q_d = I and Q_d^T T_d Q_d = diag(lambda_d), so

    (x)Q_d^T  A  (x)Q_d  =  diag( lambda_x (+) lambda_y [(+) lambda_z] )

and a solve is: transform the RHS by the Q_d^T factors (dense matmuls),
divide by the eigenvalue Kronecker sum (the all-Neumann constant
nullspace mode is zeroed — the eigenspace analogue of the reference's
MatNullSpace mean projection, navierstokes.cpp:400-412), and transform
back.  Machine-precision accurate, non-iterative, and all FLOPs live in
large dense matmuls, which accelerators run near their peak rate.

Both periodic (circulant-tridiagonal T_d, handled by the same dense eigh)
and non-periodic (Neumann wall, c=0 faces) directions work, in 2D and 3D,
on arbitrarily stretched grids.

``make_fdm_solver`` wraps the direct solve in KSP-compatible clothing:
residual check against ``max(atol, rtol*||b||)``, optional iterative
refinement (x += A~^-1 r) when low-precision rounding leaves the first
residual above tolerance, and ``SolveResult`` stats for the iterations
log (linsolverksp.cpp:96-104 semantics; `iters` counts refinements).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .krylov import SolveResult, _norm


def _apply_per_axis(mats: list, x, dim: int, precision):
    """Apply mats[d] along direction d's array axis (one dense matmul per
    axis — the shared transform of both fast-diagonalization solvers).
    ``mats[d] is None`` skips direction d (its transform is an FFT handled
    separately by the caller)."""
    for d in range(dim):
        if mats[d] is None:
            continue
        axis = dim - 1 - d
        x = jnp.moveaxis(
            jnp.tensordot(mats[d], x, axes=((1,), (axis,)),
                          precision=precision), 0, axis)
    return x


class _ShardedTransformCore:
    """Transform-axis-repartitioned separable solve (the distributed-FFT
    pattern) via shard_map + explicit all_to_all.

    A naive tensordot over a mesh-sharded axis makes GSPMD compute
    partial products and ALL-REDUCE the full grid once per transform
    (~2-3 p-field volumes of interconnect traffic per transform), and steering
    GSPMD with resharding constraints lowers to all-gathers — measured
    worse (validation/collectives.json "fdm-naive" vs constraint
    attempt).  shard_map makes the schedule explicit and optimal:

        y sharded over ALL devices -> x (and z) transforms fully local
        one all_to_all (y <-> x transpose)
        y transform fully local -> eigen-multiply -> y back-transform
        one all_to_all back -> x (and z) back-transforms local

    i.e. exactly 2 all-to-alls per solve, each moving one field volume
    split D^2 ways — no full-grid all-reduce, no gather.  Non-divisible
    axis sizes (staggered grids) are zero-padded; the transform matrices
    are zero-padded so the pad region stays exactly zero through the
    whole pipeline."""

    def __init__(self, dim: int, mesh, fwd: list, bwd: list, inv_lam,
                 precision, dtype, sizes: list,
                 fft_axes: tuple = (), fft_sizes: tuple = ()):
        self.dim, self.mesh, self.precision = dim, mesh, precision
        self.names = tuple(mesh.axis_names)
        D = int(np.prod([mesh.shape[n] for n in self.names]))
        self.D = D
        # directions: d=0 -> array axis dim-1 (x), d=1 -> dim-2 (y)
        self.ax_x, self.ax_y = dim - 1, dim - 2
        # fft axes must stay device-local (z-like, array axis < dim-2);
        # set_mesh gates on this
        self.fft_axes, self.fft_sizes = tuple(fft_axes), tuple(fft_sizes)
        padded = list(sizes)
        for d in (0, 1):  # x and y get sharded at some stage -> pad to D
            padded[d] = -(-sizes[d] // D) * D
        self.sizes, self.padded = list(sizes), padded

        def padmat(m, n_to):
            if m is None:  # fft direction: no dense factor
                return None
            n = m.shape[0]
            if n == n_to:
                return m
            out = jnp.zeros((n_to, n_to), m.dtype)
            return out.at[:n, :n].set(m)

        self.fwd = [padmat(fwd[d], padded[d]) for d in range(dim)]
        self.bwd = [padmat(bwd[d], padded[d]) for d in range(dim)]
        # inv_lam padded with zeros on the x/y axes (pad modes annihilate).
        # Kept as a plain (process-local) array: the shard_map in_spec
        # distributes it at compile time, and a device_put with a mesh
        # sharding here would be illegal to close over in multi-process
        # runs (spans non-addressable devices).
        pads = [(0, 0)] * dim
        pads[self.ax_x] = (0, padded[0] - sizes[0])
        pads[self.ax_y] = (0, padded[1] - sizes[1])
        self.inv_lam = jnp.pad(inv_lam.astype(dtype), pads)

    def solve_padded(self, b):
        try:
            from jax import shard_map
        except ImportError:  # older jax spells it experimental
            from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P

        dim, names, prec = self.dim, self.names, self.precision
        ax_x, ax_y = self.ax_x, self.ax_y

        def tdot(m, x, axis):
            return jnp.moveaxis(
                jnp.tensordot(m, x, axes=((1,), (axis,)), precision=prec),
                0, axis)

        def core(blk, invl):
            # canonical (dy, dx) block sharding -> y over ALL devices:
            # a within-dx-group all_to_all (GSPMD lowers the same
            # redistribution as an all-gather + slice, ~7x the traffic)
            x = jax.lax.all_to_all(blk, names[-1], split_axis=ax_y,
                                   concat_axis=ax_x, tiled=True)
            # y sharded over all devices -> x (and z) transforms local
            x = tdot(self.fwd[0], x, ax_x)
            for d in range(2, dim):
                if self.fwd[d] is not None:
                    x = tdot(self.fwd[d], x, dim - 1 - d)
            x = jax.lax.all_to_all(x, names, split_axis=ax_x,
                                   concat_axis=ax_y, tiled=True)
            x = tdot(self.fwd[1], x, ax_y)
            if self.fft_axes:  # z-like axes: local on every device
                x = jnp.fft.rfftn(x, axes=self.fft_axes)
            x = x * invl
            if self.fft_axes:
                x = jnp.fft.irfftn(x, s=self.fft_sizes,
                                   axes=self.fft_axes).astype(blk.dtype)
            x = tdot(self.bwd[1], x, ax_y)
            x = jax.lax.all_to_all(x, names, split_axis=ax_y,
                                   concat_axis=ax_x, tiled=True)
            x = tdot(self.bwd[0], x, ax_x)
            for d in range(2, dim):
                if self.bwd[d] is not None:
                    x = tdot(self.bwd[d], x, dim - 1 - d)
            # back to the canonical block sharding
            return jax.lax.all_to_all(x, names[-1], split_axis=ax_x,
                                      concat_axis=ax_y, tiled=True)

        canon = [None] * dim
        canon[ax_y], canon[ax_x] = names[-2], names[-1]
        spec_x = [None] * dim
        spec_x[ax_x] = names
        return shard_map(core, mesh=self.mesh,
                         in_specs=(P(*canon), P(*spec_x)),
                         out_specs=P(*canon))(b, self.inv_lam)

    def solve(self, b):
        dim = self.dim
        pads = [(0, 0)] * dim
        pads[self.ax_x] = (0, self.padded[0] - self.sizes[0])
        pads[self.ax_y] = (0, self.padded[1] - self.sizes[1])
        x = self.solve_padded(jnp.pad(b, pads))
        sl = [slice(None)] * dim
        sl[self.ax_x] = slice(0, self.sizes[0])
        sl[self.ax_y] = slice(0, self.sizes[1])
        return x[tuple(sl)]


def _canonical_constraint(x, dim: int, mesh):
    """Restore the solver-wide grid sharding (trailing two axes over the
    mesh axes — mirrors parallel.dist._leaf_spec)."""
    from jax.sharding import NamedSharding, PartitionSpec

    names = tuple(mesh.axis_names)
    k = min(len(names), x.ndim)
    spec = [None] * x.ndim
    spec[x.ndim - k:] = names[len(names) - k:]
    return jax.lax.with_sharding_constraint(
        x, NamedSharding(mesh, PartitionSpec(*spec)))


def _uniform_width(widths: np.ndarray, rtol: float = 1e-9) -> float | None:
    """The common cell width when the axis is uniformly spaced, else None."""
    w = np.asarray(widths, np.float64)
    h = float(w.mean())
    return h if np.allclose(w, h, rtol=rtol, atol=0.0) else None


def _fft_symbol(n: int, h: float, scale: float) -> np.ndarray:
    """Generalized eigenvalues of the periodic uniform 1D FV Poisson factor
    (circulant T with faces scale/h, weight W = h I) in DFT-frequency
    order: lambda_k = 2*scale*(1 - cos(2 pi k / n)) / h^2."""
    k = np.arange(n)
    return 2.0 * scale * (1.0 - np.cos(2.0 * np.pi * k / n)) / (h * h)


def fdm_config(params: dict) -> dict:
    """Normalize ``parameters.fdm`` (bool shorthand or knob dict) into a
    dict — shared by the pressure and velocity wiring so the two paths
    cannot drift."""
    cfg = params.get("fdm", {})
    if cfg is False:
        return {"enabled": False}
    if not isinstance(cfg, dict):
        return {}
    return cfg


def line_operator(widths: np.ndarray, periodic: bool, scale: float) -> np.ndarray:
    """Dense 1D FV operator T_d (float64): face coefficient scale/dist,
    zero-flux at non-periodic walls, wraparound where periodic — the same
    construction as PoissonMG's finest level (mg.py:120-127)."""
    w = np.asarray(widths, np.float64)
    n = len(w)
    c = np.zeros(n + 1)
    c[1:-1] = 1.0 / (0.5 * (w[:-1] + w[1:]))
    if periodic:
        c[0] = c[-1] = 1.0 / (0.5 * (w[0] + w[-1]))
    c *= scale
    T = np.zeros((n, n))
    idx = np.arange(n)
    T[idx, idx] = c[:-1] + c[1:]
    T[idx[1:], idx[:-1]] -= c[1:-1]
    T[idx[:-1], idx[1:]] -= c[1:-1]
    if periodic and n > 1:
        T[0, -1] -= c[0]
        T[-1, 0] -= c[0]
    return T


class FastDiagPoisson:
    """Direct separable Poisson solver via per-direction eigendecomposition.

    Solves (positive semidefinite) ``A x = b`` where A is the *negated*
    -D B1 G operator — the same sign convention as PoissonMG/apply_op.
    """

    def __init__(self, dxp: list[np.ndarray], periodic: list[bool],
                 dtype=jnp.float32, scale: float = 1.0,
                 precision: str = "highest", null_rtol: float = 1e-12,
                 use_fft: bool = True):
        """``dxp``: pressure cell widths per direction (x, y[, z]);
        ``scale``: the dt factor of B1; ``precision``: matmul precision for
        the eigenvector transforms ('highest' = full f32; 'default' lets
        an f32 product run in TF32 on a GPU with tensor cores, ~1e-3
        transform accuracy — the refinement loop absorbs the difference).

        ``use_fft``: periodic *uniformly spaced* directions are circulant,
        so their eigenbasis is the Fourier basis — the dense (n, n)
        eigenvector matmuls become rfft/irfft with the analytic symbol
        2*scale*(1-cos(2 pi k/n))/h^2, O(n log n) instead of O(n^2) per
        line (the DNS-scale path: 256^3 TGV).  Periodic stretched and all
        non-periodic directions keep the dense eigh transforms."""
        self.dim = len(dxp)
        self.dtype = dtype
        self._n = [len(np.asarray(d)) for d in dxp]  # per direction
        self.precision = jax.lax.Precision(
            {"highest": "highest", "default": "default",
             "high": "high"}[str(precision).lower()])

        qs, qts, lams = [], [], []
        fft_axes, fft_scale = [], 1.0
        for d in range(self.dim):
            w = np.asarray(dxp[d], np.float64)
            h = _uniform_width(w) if (use_fft and periodic[d]) else None
            if h is not None:
                qs.append(None)
                qts.append(None)
                lams.append(_fft_symbol(len(w), h, scale))
                fft_axes.append(self.dim - 1 - d)
                # Q_d = F/sqrt(h): the unnormalized fft/ifft pair absorbs
                # F F^H = I but not the two 1/sqrt(h) weights
                fft_scale /= h
                continue
            T = line_operator(w, periodic[d], scale)
            # generalized symmetric eigenproblem T q = lam W q via the
            # W^{-1/2} similarity: S = W^-1/2 T W^-1/2, Q = W^-1/2 V
            s = 1.0 / np.sqrt(w)
            S = T * s[:, None] * s[None, :]
            lam, V = np.linalg.eigh(S)
            Q = s[:, None] * V
            qs.append(jnp.asarray(Q, dtype))
            qts.append(jnp.asarray(Q.T.copy(), dtype))
            lams.append(np.maximum(lam, 0.0))
        self._fft_axes = tuple(sorted(fft_axes))
        self._fft_sizes = tuple(len(np.asarray(dxp[self.dim - 1 - ax]))
                                for ax in self._fft_axes)

        # eigenvalue Kronecker sum over the (z, y[, x]) grid, inverted in
        # f64 with the nullspace mode(s) zeroed: lam_sum ~ 0 only at the
        # product of each direction's constant mode (all-Neumann/periodic).
        # The real-to-complex rfft halves the LAST fft axis to n//2+1.
        shape = list(reversed([len(np.asarray(d)) for d in dxp]))
        lams_ax = [None] * self.dim
        for d, lam in enumerate(lams):
            lams_ax[self.dim - 1 - d] = lam
        if self._fft_axes:
            rax = self._fft_axes[-1]
            lams_ax[rax] = lams_ax[rax][:shape[rax] // 2 + 1]
            shape[rax] = shape[rax] // 2 + 1
        lam_sum = np.zeros(tuple(shape))
        for ax, lam in enumerate(lams_ax):
            bshape = [1] * self.dim
            bshape[ax] = len(lam)
            lam_sum = lam_sum + lam.reshape(bshape)
        cutoff = null_rtol * lam_sum.max()
        self.inv_lam = jnp.asarray(
            np.where(lam_sum > cutoff,
                     fft_scale / np.where(lam_sum > 0, lam_sum, 1.0),
                     0.0), dtype)
        self._Q = qs
        self._Qt = qts
        self._mesh = None
        self._shard_core = None

    def set_mesh(self, mesh) -> None:
        """Enable transform-axis repartitioning under this device mesh
        (see _ShardedTransformCore; dense-transform axes only)."""
        self._mesh = mesh
        # fft axes are fine as long as they stay device-local (z-like)
        if (self.dim >= 2 and len(mesh.axis_names) == 2
                and all(ax < self.dim - 2 for ax in self._fft_axes)):
            self._shard_core = _ShardedTransformCore(
                self.dim, mesh, self._Qt, self._Q, self.inv_lam,
                self.precision, self.dtype, sizes=self._n,
                fft_axes=self._fft_axes, fft_sizes=self._fft_sizes)

    def _transform(self, mats: list, x):
        return _apply_per_axis(mats, x, self.dim, self.precision)

    def solve(self, b):
        """x = A^+ b: the inconsistent (nonzero plain-sum) component of b
        is projected out first — Q Lam^+ Q^T alone is only a *reflexive*
        generalized inverse, so on stretched grids a nonzero-sum b would
        otherwise leak through the non-W-orthogonality of the constant
        mode (tests/test_fdm.py::test_nullspace_component_discarded).
        The returned x carries no nullspace component in the W-weighted
        inner product."""
        b = b.astype(self.dtype)
        b = b - jnp.mean(b)  # range(A) = plain-sum-zero vectors
        if self._shard_core is not None and b.ndim == self.dim:
            return _canonical_constraint(self._shard_core.solve(b),
                                         self.dim, self._mesh)
        # dense transforms first (real matmuls), FFTs innermost — the
        # reverse order on the way back keeps the dense matmuls real
        bhat = self._transform(self._Qt, b)
        if self._fft_axes:
            bhat = jnp.fft.rfftn(bhat, axes=self._fft_axes)
        xhat = bhat * self.inv_lam
        if self._fft_axes:
            xhat = jnp.fft.irfftn(xhat, s=self._fft_sizes,
                                  axes=self._fft_axes).astype(self.dtype)
        x = self._transform(self._Q, xhat)
        if self._mesh is not None and x.ndim == self.dim:
            x = _canonical_constraint(x, self.dim, self._mesh)
        return x


class FastDiagHelmholtz:
    """Direct fast-diagonalization solver for one velocity component's
    Helmholtz operator  A = I/dt - c_imp*nu*L  (the implicit momentum
    system, navierstokes.cpp:317-330).

    The BC-folded homogeneous Laplacian L is an exact Kronecker sum of 1D
    operators T_d (coefficients 1/(dneg*dl), 1/(dpos*dl) from the
    component's grid lines; the static per-face a0 ghost fold only
    modifies the end diagonals; periodic directions wrap) — the same
    separability the pressure solve exploits, plus a 1/dt shift that
    makes the operator SPD with no nullspace.  Each T_d is symmetric
    under the W_d = diag(dl) weighting, so T_d = Q_d Lam_d Q_d^{-1} with
    Q_d = W^-1/2 V_d and Q_d^{-1} = V_d^T W^1/2 (NOT Q^T — the forward
    and backward transforms differ, unlike the conservative pressure
    operator).  A solve is: transform by Q^-1, divide by
    1/dt - c_imp*nu*lam_sum, transform back — dense matmuls.

    Used as the (near-exact) preconditioner of the velocity Krylov solve:
    CG/BiCGStab then converges in ~1 iteration instead of 3-6 with
    Jacobi, and the stopping semantics stay KSP-identical.
    """

    def __init__(self, lines1d: list[dict], dt: float, cnu: float,
                 dtype=jnp.float32, precision: str = "highest",
                 use_fft: bool = True):
        """``lines1d``: per direction d a dict with keys ``dl`` (n,),
        ``dneg`` (n,), ``dpos`` (n,), ``a0`` ((lo, hi) or None when
        periodic), ``periodic`` (bool); ``cnu`` = c_implicit * nu.

        ``use_fft``: periodic uniform directions (dl = dneg = dpos = h)
        have circulant T_d = (1/h^2) circ(-2, 1, ..., 1), so Q = F and
        Q^-1 = F^H exactly — rfft/irfft with the analytic symbol
        -(2 - 2 cos(2 pi k / n))/h^2 replace the dense transforms (and
        need no width factor, unlike the conservative Poisson form)."""
        self.dim = len(lines1d)
        self.dtype = dtype
        self._n = [len(np.asarray(ln["dl"])) for ln in lines1d]
        self.precision = jax.lax.Precision(
            {"highest": "highest", "default": "default",
             "high": "high"}[str(precision).lower()])

        qs, qinvs, lams = [], [], []
        fft_axes = []
        for d, ln in enumerate(lines1d):
            dl = np.asarray(ln["dl"], np.float64)
            dneg = np.asarray(ln["dneg"], np.float64)
            dpos = np.asarray(ln["dpos"], np.float64)
            n = len(dl)
            if use_fft and ln["periodic"]:
                h = _uniform_width(dl)
                if (h is not None
                        and np.allclose(dneg, h, rtol=1e-9, atol=0.0)
                        and np.allclose(dpos, h, rtol=1e-9, atol=0.0)):
                    qs.append(None)
                    qinvs.append(None)
                    lams.append(-_fft_symbol(n, h, 1.0))  # -(2-2cos)/h^2
                    fft_axes.append(self.dim - 1 - d)
                    continue
            cn = 1.0 / (dneg * dl)
            cp = 1.0 / (dpos * dl)
            T = np.zeros((n, n))
            idx = np.arange(n)
            T[idx, idx] = -(cn + cp)
            T[idx[1:], idx[:-1]] = cn[1:]
            T[idx[:-1], idx[1:]] = cp[:-1]
            if ln["periodic"]:
                T[0, -1] += cn[0]
                T[-1, 0] += cp[-1]
            else:
                a0_lo, a0_hi = ln["a0"]
                T[0, 0] += a0_lo * cn[0]      # ghost = a0 * target fold
                T[-1, -1] += a0_hi * cp[-1]
            # W-weighted symmetry: W^1/2 T W^-1/2 is symmetric
            s = np.sqrt(dl)
            S = T * (s[:, None] / s[None, :])
            asym = np.abs(S - S.T).max()
            if asym > 1e-10 * max(1.0, np.abs(S).max()):
                raise ValueError(
                    f"velocity 1D operator not W-symmetric (dev {asym:g})")
            S = 0.5 * (S + S.T)
            lam, V = np.linalg.eigh(S)
            qs.append(jnp.asarray(V / s[:, None], dtype))       # W^-1/2 V
            qinvs.append(jnp.asarray((V * s[:, None]).T, dtype))  # V^T W^1/2
            lams.append(lam)
        self._fft_axes = tuple(sorted(fft_axes))
        self._fft_sizes = tuple(len(np.asarray(lines1d[self.dim - 1 - ax]
                                               ["dl"]))
                                for ax in self._fft_axes)

        shape = list(reversed([len(np.asarray(ln["dl"]))
                               for ln in lines1d]))
        lams_ax = [None] * self.dim
        for d, lam in enumerate(lams):
            lams_ax[self.dim - 1 - d] = lam
        if self._fft_axes:
            rax = self._fft_axes[-1]
            lams_ax[rax] = lams_ax[rax][:shape[rax] // 2 + 1]
            shape[rax] = shape[rax] // 2 + 1
        lam_sum = np.zeros(tuple(shape))
        for ax, lam in enumerate(lams_ax):
            bshape = [1] * self.dim
            bshape[ax] = len(lam)
            lam_sum = lam_sum + lam.reshape(bshape)
        denom = 1.0 / dt - cnu * lam_sum  # lam <= 0 -> denom >= 1/dt > 0
        self.inv_lam = jnp.asarray(1.0 / denom, dtype)
        self._Q = qs
        self._Qinv = qinvs
        self._mesh = None
        self._shard_core = None

    def set_mesh(self, mesh) -> None:
        """Enable transform-axis repartitioning under this device mesh
        (see _ShardedTransformCore; dense-transform axes only)."""
        self._mesh = mesh
        if (self.dim >= 2 and len(mesh.axis_names) == 2
                and all(ax < self.dim - 2 for ax in self._fft_axes)):
            self._shard_core = _ShardedTransformCore(
                self.dim, mesh, self._Qinv, self._Q, self.inv_lam,
                self.precision, self.dtype, sizes=self._n,
                fft_axes=self._fft_axes, fft_sizes=self._fft_sizes)

    def _transform(self, mats: list, x):
        return _apply_per_axis(mats, x, self.dim, self.precision)

    def solve(self, b):
        b = b.astype(self.dtype)
        if self._shard_core is not None and b.ndim == self.dim:
            return _canonical_constraint(self._shard_core.solve(b),
                                         self.dim, self._mesh)
        bhat = self._transform(self._Qinv, b.astype(self.dtype))
        if self._fft_axes:
            bhat = jnp.fft.rfftn(bhat, axes=self._fft_axes)
        xhat = bhat * self.inv_lam
        if self._fft_axes:
            xhat = jnp.fft.irfftn(xhat, s=self._fft_sizes,
                                  axes=self._fft_axes).astype(self.dtype)
        x = self._transform(self._Q, xhat)
        if self._mesh is not None and x.ndim == self.dim:
            x = _canonical_constraint(x, self.dim, self._mesh)
        return x


def helmholtz_lines(mesh, bcset, c: int) -> list[dict]:
    """Extract the per-direction 1D data of velocity component ``c``'s
    folded Laplacian (the same coefficients make_laplacian bakes into its
    stencil closures, operators/stencil.py:118-129)."""
    from ..types import Field

    out = []
    for d in range(mesh.dim):
        line = mesh.lines[Field(c)][d]
        if mesh.periodic[d]:
            a0 = None
        else:
            a0 = (bcset.specs[(c, 2 * d + 0)].a0,
                  bcset.specs[(c, 2 * d + 1)].a0)
        out.append({"dl": line.interior_dl, "dneg": line.dneg(),
                    "dpos": line.dpos(), "a0": a0,
                    "periodic": bool(mesh.periodic[d])})
    return out


def make_fdm_solver(fdm, A, opts: dict):
    """Direct solve + iterative refinement with KSP stopping semantics.

    ``fdm`` is any object with a ``solve(b)`` pytree->pytree (near-)exact
    inverse (FastDiagPoisson on a pressure array, or a per-component
    FastDiagHelmholtz dict for the momentum system); ``A`` the matching
    operator used for the TRUE residual.  Returns ``solve(b, x0) ->
    SolveResult``; ``x0`` is ignored (direct methods need no initial
    guess).  Convergence is always judged on the true residual, which
    makes this valid even where the transform inverse is only
    W-symmetric (plain CG with such a preconditioner silently
    misconverges — caught by tests/test_fdm.py).  A stagnation exit
    (residual shrinking by < 10% per pass) reports non-convergence
    instead of looping to max_it, the analogue of
    KSP_DIVERGED_BREAKDOWN."""
    atol = float(opts.get("atol", 1e-6))
    rtol = float(opts.get("rtol", 0.0))
    maxiter = int(opts.get("max_it", 10000))
    tmap = jax.tree_util.tree_map

    def solve(b, x0):
        # Warm start + RECURRENCE residual updates — both matter in f32:
        # (1) refining from x0 keeps the transform rounding at the scale
        # of ||b - A x0|| (small in developed flow), not ||b||
        # (~||u||/dt ~ 1e5 on the momentum system at atol 1e-6);
        # (2) a freshly evaluated b - A x carries eps*||b|| noise (~1e-2
        # there), so convergence is judged on r_{k+1} = r_k - A dx_k,
        # whose arithmetic stays at the correction scale — exactly the
        # residual semantics of the reference's KSP recurrences
        # (linsolverksp.cpp / KSPSolve default norm).
        r = tmap(lambda bi, ax: bi - ax, b, A(x0))
        dx = fdm.solve(r)
        x = tmap(lambda xi, di: xi + di, x0, dx)
        r = tmap(lambda ri, adi: ri - adi, r, A(dx))
        tol = jnp.maximum(atol, rtol * _norm(b))
        rnorm = _norm(r)

        def cond(state):
            _, _, rn, prev, it = state
            return (rn > tol) & (rn < 0.9 * prev) & (it < maxiter)

        def body(state):
            x, r, rn, _, it = state
            dx = fdm.solve(r)
            x = tmap(lambda xi, di: xi + di, x, dx)
            r = tmap(lambda ri, adi: ri - adi, r, A(dx))
            return x, r, _norm(r), rn, it + 1

        big = jnp.asarray(np.inf, rnorm.dtype)
        x, r, rnorm, _, it = jax.lax.while_loop(
            cond, body, (x, r, rnorm, big, jnp.asarray(0, jnp.int32)))
        return SolveResult(x=x, iters=it, residual=rnorm,
                           converged=rnorm <= tol)

    return solve
