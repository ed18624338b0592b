"""Projection-method incompressible Navier-Stokes solver.

JAX re-design of the reference's NavierStokesSolver application
(reference: applications/navierstokes/navierstokes.{h,cpp}).  The whole
time step — RHS assembly, BiCGStab momentum solve, CG Poisson solve,
projection, pressure update, ghost refresh — is one jitted function over a
state pytree; PETSc Mats become stencil closures, KSP becomes the native
Krylov module, and the packed velocity Vec becomes the ``{u, v, w}`` dict.

Scheme (Perot 1993 fractional step, navierstokes.cpp:240-266):
  1. rhs1 = -G p + u/dt + sum_k conv-coef_k * (-N u)_k
           + sum_k diff-coef_k * nu (L+Lbc) u_k + a_imp * nu Lbc u   (:432-521)
  2. solve (I/dt - a_imp nu L) u* = rhs1                              (:524)
  3. rhs2 = (D + Dbc) u*                                              (:540-563)
  4. solve D B_N G dp = rhs2                                          (:566)
  5. u = u* - B_N G dp ; p += dp                                      (:583-615)
  6. refresh ghost values                                             (:263)

The IBM solvers subclass this driver exactly like the reference's class
hierarchy (SURVEY.md §1) via the ``_extra_init`` hook and ``_build_step``
override; solver state is one dict pytree so subclasses can extend it.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from .. import io as pio
from ..boundary import BoundarySet
from ..config import solver_config
from ..ics import initial_fields
from ..linalg import extract_diagonal, make_solver
from ..mesh import StaggeredMesh
from ..operators import (
    make_bn,
    make_convection,
    make_divergence,
    make_gradient,
    make_laplacian,
)
from ..timeintegration import create_time_integration
from ..types import Field
from ..utils.timers import StageTimers

tmap = jax.tree_util.tree_map

VEL_NAMES = ("u", "v", "w")


def _default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


#: root of the checkout (the directory holding the package)
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    A directory JAX already has (``JAX_COMPILATION_CACHE_DIR``, or one a
    caller set through ``jax.config``) is used as it is.  Otherwise the
    cache goes to ``<checkout>/.jax_cache``, one fixed path, so every run
    from the same checkout finds what earlier runs compiled (the fused
    step with its Krylov loops takes tens of seconds to compile)."""
    path = jax.config.jax_compilation_cache_dir
    if not path:
        path = os.path.join(_CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def _setup_device():
    """Context for init-time eager setup math (delta windows, FDM and
    Schur factors, ICs).  Setup is dozens of small one-shot eager ops, and
    on an accelerator each one compiles and launches its own kernel, so by
    default setup is pinned to the host CPU backend: constructing the
    450x450 decoupled-IBPM cylinder (bench.py) took 4.6-5.0 s pinned and
    10.0-10.9 s unpinned on an H100 SXM (400 W limit), two runs each.
    ``PETIBM_SETUP_DEVICE`` overrides: a platform name (``cpu``, ``gpu``,
    ...) pins setup there; '' or ``none`` disables pinning.  Arrays created
    here are uncommitted, so the jitted step still places everything on
    the default device at its first call."""
    import contextlib
    import warnings

    want = os.environ.get("PETIBM_SETUP_DEVICE", "cpu").lower()
    if want in ("", "none"):
        return contextlib.nullcontext()
    try:
        # local_devices, not devices: under multi-process jax.distributed
        # the global list leads with process 0's devices, and pinning
        # setup arrays to a non-addressable device breaks every later
        # host access on other ranks (caught by tests/test_multihost.py)
        dev = jax.local_devices(backend=want)[0]
    except RuntimeError as exc:  # platform not registered / unknown
        warnings.warn(
            f"PETIBM_SETUP_DEVICE={want!r}: no such backend ({exc}); "
            "running setup on the default device")
        return contextlib.nullcontext()
    return jax.default_device(dev)


class NavierStokesSolver:
    """The projection-method driver (library-composable; IBPM and the
    decoupled IBPM inherit the skeleton, reference: navierstokes.h:29-292)."""

    # subclasses replacing the pressure Poisson system set this to skip
    # building the base p_solver (coupled IBPM)
    _skip_base_poisson = False

    def __init__(self, config: dict):
        self.config = config
        self.timers = StageTimers()
        # multi-host bring-up MUST precede the first backend query —
        # _setup_device() below calls jax.devices(), after which
        # jax.distributed.initialize refuses to run (the MPI_Init
        # analogue; reference: PetscInitialize in every app main.cpp;
        # exercised for real by tests/test_multihost.py)
        from ..parallel import maybe_initialize

        maybe_initialize(config.get("parameters", {}).get("distributed"))
        with self.timers.stage("initialize"), _setup_device():
            self._init(config)

    # ------------------------------------------------------------------
    def _init(self, config: dict) -> None:
        params = config.get("parameters", {})
        self.dt = float(params["dt"])
        self.nstart = int(params.get("startStep", 0))
        self.ite = self.nstart
        self.t = float(params.get("t", 0.0))
        self.nt = int(params.get("nt", 1))
        self.nsave = int(params.get("nsave", self.nt))
        self.nrestart = int(params.get("nrestart", self.nt))
        self.nu = float(config["flow"]["nu"])
        dtype_name = params.get("dtype")
        self.dtype = jnp.dtype(dtype_name) if dtype_name else _default_dtype()

        enable_compile_cache()

        # multi-chip spatial domain decomposition (the reference's DMDA
        # decomposition, cartesianmesh.cpp:492-538): a `parameters.sharding`
        # node shards every grid field over a ("dy","dx") device mesh;
        # GSPMD inserts the halo exchanges and psum reductions
        from ..parallel import mesh_from_config

        # (multi-host bring-up already happened in __init__, before the
        # first backend query)
        self.sharding_mesh = mesh_from_config(params.get("sharding"))
        # XLA:CPU emulates collectives with an in-process thread rendezvous
        # that can deadlock when many multi-device executions are in flight
        # (observed: collective-permute rendezvous timeouts after ~O(100)
        # unsynced steps on an 8-device host mesh); accelerator collectives
        # have no such limit, so only the CPU backend gets a per-step sync
        self._sync_every_step = (
            self.sharding_mesh is not None
            and self.sharding_mesh.devices.flat[0].platform == "cpu")

        self.mesh = StaggeredMesh(config)
        self.output_dir = config.get("output", os.getcwd())
        self.logs_dir = config.get("logs", self.output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        os.makedirs(self.logs_dir, exist_ok=True)
        # nsave: 0 (and nrestart: 0) turn field output off, so a run can
        # go without the HDF5 writer; asking for output without h5py
        # installed fails here, before any time step
        if self.nsave > 0 or self.nrestart > 0 or self.nstart > 0:
            pio.require_h5py()
        if self.nsave > 0:
            pio.write_grid(self.mesh, os.path.join(self.output_dir,
                                                   "grid.h5"))

        self.bc = BoundarySet(self.mesh, config)

        # initial conditions (solutionsimple.cpp:122-228)
        fields0 = initial_fields(config, self.mesh, t=self.t)
        q = {VEL_NAMES[c]: jnp.asarray(fields0[VEL_NAMES[c]], self.dtype)
             for c in range(self.mesh.dim)}
        self.state = {
            "q": q,
            "p": jnp.asarray(fields0["p"], self.dtype),
            "bc": None,  # filled below
            "conv": (),
            "diff": (),
        }
        self.state["bc"] = self.bc.init_state(q, self.dtype)
        self.state["dP"] = jnp.zeros_like(self.state["p"])

        self.conv_ti = create_time_integration("convection", config)
        self.diff_ti = create_time_integration("diffusion", config)
        zero_q = tmap(jnp.zeros_like, q)
        self.state["conv"] = tuple(zero_q for _ in range(self.conv_ti.n_explicit))
        self.state["diff"] = tuple(zero_q for _ in range(self.diff_ti.n_explicit))

        self._create_operators(config)
        self._create_solvers(config)
        self._create_probes(config)
        self._extra_init(config)
        step = self._build_step()
        if self.sharding_mesh is not None:
            from ..parallel import sharded_step

            step = sharded_step(self.sharding_mesh, step)
        self._step_fn = jax.jit(step)
        # steps per dispatch: lax.scan k steps inside one XLA program so
        # per-dispatch host latency (comparable to a small grid's whole
        # step) amortizes across k steps;
        # run() falls back to single steps near host-event boundaries
        # (saves, restarts, probe monitors) so output cadence is unchanged
        self.steps_per_dispatch = max(1, int(params.get("stepsPerDispatch",
                                                        1)))
        self._chunk_fn = None
        if self.steps_per_dispatch > 1:
            k = self.steps_per_dispatch

            def chunk(state):
                return jax.lax.scan(lambda s, _: step(s), state, None,
                                    length=k)

            self._chunk_fn = jax.jit(chunk)

        self.iter_log_path = os.path.join(
            self.output_dir, f"iterations-{self.ite}.txt")
        self._iter_log = open(self.iter_log_path, "w")
        self._last_stats = None
        self._stats_buffer = []
        # reference parity: KSP SETERRQs when a solve diverges
        # (linsolverksp.cpp:96-104).  "abort" raises SolverDivergedError at
        # the next buffered-stats flush (per-step device syncs would stall
        # the async pipeline); "warn" prints and continues; "ignore" is the
        # round-2 behavior.
        self.divergence_policy = str(params.get("divergence", "abort"))
        if self.divergence_policy not in ("abort", "warn", "ignore"):
            raise ValueError(
                f"parameters.divergence must be abort|warn|ignore, got "
                f"{self.divergence_policy!r}")

    def _extra_init(self, config: dict) -> None:
        """Subclass hook (bodies, extra operators/solvers)."""

    # ------------------------------------------------------------------
    def _create_operators(self, config: dict) -> None:
        """Stencil closures replacing createOperators
        (navierstokes.cpp:317-365)."""
        mesh, bc, dtype = self.mesh, self.bc, self.dtype
        self.grad = make_gradient(mesh, dtype)
        self.div = make_divergence(mesh, bc, dtype)
        self.lap = make_laplacian(mesh, bc, dtype)
        self.convect = make_convection(mesh, bc, dtype)
        self.bn_order = int(config.get("parameters", {}).get("BN", 1))
        self.bn = make_bn(self.lap, self.dt,
                          self.diff_ti.implicit_coeff * self.nu, self.bn_order)

        dt, nu, cimp = self.dt, self.nu, self.diff_ti.implicit_coeff

        def A_momentum(u):
            lu = self.lap(u, None, homogeneous=True)
            return tmap(lambda a, b: a / dt - cimp * nu * b, u, lu)

        def A_poisson(phi):
            return self.div(self.bn(self.grad(phi)), None, homogeneous=True)

        self.A_momentum = A_momentum
        self.A_poisson = A_poisson

    def _create_solvers(self, config: dict) -> None:
        """Krylov solvers + nullspace handling replacing createLinSolver and
        setNullSpace (navierstokes.cpp:150-154, 395-429)."""
        vopts = solver_config(config, "velocity")
        popts = solver_config(config, "poisson")
        mesh, dtype = self.mesh, self.dtype
        # the pressure solve's building blocks, set by _make_poisson_pc:
        # the FDM inverse (BN order 1) or, where a V-cycle runs, the MG
        # hierarchy
        self.poisson_fdm = None
        self.poisson_mg = None
        self._fdm_mode = None

        # velocity preconditioner: fast-diagonalization Helmholtz inverse
        # (the implicit operator is an exact Kronecker sum per component,
        # linalg/fdm.py FastDiagHelmholtz) — the Krylov solve then takes
        # ~1 iteration.  Jacobi fallback for pc: jacobi, fully-explicit
        # diffusion (where A = I/dt is diagonal anyway), or fdm: false.
        from ..linalg.fdm import fdm_config

        q = self.state["q"]
        fdm_cfg = fdm_config(config.get("parameters", {}))
        cnu = self.diff_ti.implicit_coeff * self.nu
        # an EXPLICIT pc choice (options file / inline) wins over the FDM
        # default; the role's implicit jacobi default does not
        pc_user = (vopts.get("pc")
                   if vopts.get("pc_explicit") else None)
        want_vfdm = (bool(fdm_cfg.get("enabled", True))
                     and bool(fdm_cfg.get("velocity", True))
                     and cnu > 0.0 and pc_user is None)
        if want_vfdm:
            # direct solve + true-residual refinement: the Helmholtz
            # inverse is only W-symmetric, so it is NOT a valid plain-CG
            # preconditioner (silent misconvergence — see fdm.py); the
            # refinement solver judges convergence on the true residual
            # and, with kappa(A) ~ 1 + dt*c*nu*lam_max (the 1/dt shift
            # dominates), converges in 0-1 passes even in f32
            from ..linalg.fdm import (FastDiagHelmholtz, helmholtz_lines,
                                      make_fdm_solver)

            # default-precision transforms: an f32 matmul at "default"
            # runs in TF32 on tensor-core GPUs (and in full f32 on the
            # CPU); the true-residual refinement absorbs the rounding
            helm = {VEL_NAMES[c]: FastDiagHelmholtz(
                helmholtz_lines(mesh, self.bc, c), self.dt, cnu,
                dtype=self.dtype,
                precision=fdm_cfg.get("velocityPrecision", "default"),
                use_fft=bool(fdm_cfg.get("fft", False)))
                for c in range(mesh.dim)}
            if (self.sharding_mesh is not None
                    and bool(fdm_cfg.get("repartition", True))):
                for h in helm.values():
                    h.set_mesh(self.sharding_mesh)

            class _HelmDict:
                @staticmethod
                def solve(r):
                    return {k: helm[k].solve(v) for k, v in r.items()}

            self.v_solver = make_fdm_solver(_HelmDict, self.A_momentum,
                                            vopts)
        else:
            M_mom = None
            if vopts.get("pc") != "none":
                diag_mom = extract_diagonal(self.A_momentum,
                                            tmap(jnp.zeros_like, q),
                                            radius=1)

                def M_mom(r):
                    return tmap(lambda a, b: a / b, r, diag_mom)

            self.v_solver = make_solver(self.A_momentum, vopts, M=M_mom)
        # warm starts reuse the previous step's solution/correction as the
        # Krylov initial guess — converged states are identical to the
        # reference's zero-guess KSP within the same tolerances, with far
        # fewer iterations in developed flow
        params = config.get("parameters", {})
        self.warm_start = bool(params.get("warmStart", True))
        self.warm_start_poisson = bool(params.get("warmStartPoisson", True))

        if self._skip_base_poisson:
            # the coupled IBPM replaces the pressure-only Poisson system
            # with its own {p, f} block operator (ibpm.py); building the
            # base p_solver here would be wasted setup work
            return

        # pinned pressure (AmgX path) vs mean-projection (KSP path)
        self.is_ref_p = popts.get("backend") == "GPU"
        if self.is_ref_p:
            # MatZeroRowsColumns on row/col 0 with unit diagonal
            # (navierstokes.cpp:414-420)
            def A_p(phi):
                flat = phi.reshape(-1)
                phi0 = flat.at[0].set(0.0).reshape(phi.shape)
                y = self.A_poisson(phi0).reshape(-1)
                y = y.at[0].set(flat[0])
                return y.reshape(phi.shape)
        else:
            A_p = self.A_poisson

        # CG wants SPD; D Bn G is symmetric negative semidefinite -> negate
        def negA_p(phi):
            return -A_p(phi)

        self._negA_p = negA_p
        if (self.is_ref_p and self.bn_order == 1
                and self.sharding_mesh is None
                and bool(fdm_cfg.get("enabled", True))):
            # pinned-pressure (AmgX-parity) backend: the pinned system's
            # exact inverse reduces to the projected FDM solve with a
            # compatibility shift + gauge fix (same algebra as the
            # coupled solver's pinned adapter, solvers/ibpm.py) — MG-CG
            # on the pinned system needs ~80 V-cycles/step at 450^2
            # while this is two transform sets.  Honors fdm: false.
            from ..linalg.fdm import FastDiagPoisson, make_fdm_solver

            fdm_pin = FastDiagPoisson(
                self.mesh.dxp, self.mesh.periodic, dtype=self.dtype,
                scale=self.dt,
                precision=fdm_cfg.get("precision", "highest"))

            class _PinnedPoisson:
                @staticmethod
                def solve(r):
                    rf = r.reshape(-1)
                    s = rf[0]
                    beta = s - jnp.sum(rf)  # -sum over i != 0
                    x = fdm_pin.solve(
                        rf.at[0].set(beta).reshape(r.shape)).reshape(-1)
                    return (x - x[0]).at[0].set(s).reshape(r.shape)

            self.p_solver = make_fdm_solver(_PinnedPoisson, negA_p, popts)
            self._poisson_fdm_pinned = fdm_pin
            return

        M_p = self._make_poisson_pc(popts)
        if self.poisson_fdm is not None and self._fdm_mode == "direct":
            # direct fast-diagonalization solve (+ residual-checked
            # refinement).  The "pcg" mode instead runs CG with the FDM pseudo-
            # inverse as preconditioner (M_p above): in f32 the direct
            # pass lands ~1e-5 relative and plain refinement contracts
            # only by ~kappa*eps per pass, while CG's minimization
            # reaches the same floor as the round-3 CG+MG path in ~2
            # iterations (tests/test_fdm.py::test_float32_accuracy)
            from ..linalg.fdm import make_fdm_solver

            self.p_solver = make_fdm_solver(self.poisson_fdm, negA_p, popts)
        else:
            self.p_solver = make_solver(negA_p, popts, M=M_p)

    def _make_poisson_pc(self, popts: dict):
        """Pressure solve strategy for the (negated) Poisson operator.

        For BN order 1 (the reference's default) the operator is an exactly
        separable Kronecker sum, so the default is the *direct* fast-
        diagonalization solver (linalg/fdm.py) — per-direction
        eigendecompositions at setup, dense matmuls per solve —
        replacing the iterative CG + multigrid path entirely (the
        reference's `-pc_type gamg` / AmgX, navierstokes.cpp:566-580).
        BN > 1 and the pinned-pressure (GPU-backend) variant keep the
        geometric-multigrid-preconditioned CG; `pc: jacobi` keeps
        probed-diagonal Jacobi.  Opt out of the direct solver with
        ``parameters: {fdm: false}`` (or ``fdm: {enabled: false}``)."""
        pc = popts.get("pc", "mg")
        if pc == "none":
            return None
        params = self.config.get("parameters", {})
        if pc in ("mg", "fdm"):
            from ..linalg.fdm import fdm_config

            fdm_cfg = fdm_config(params)
            eligible = self.bn_order == 1 and not self.is_ref_p
            want = (bool(fdm_cfg.get("enabled", True))
                    if pc == "mg" else True)
            if pc == "fdm" and not eligible:
                raise ValueError(
                    "poisson pc 'fdm' requires BN order 1 and the "
                    "CPU-backend (mean-projection) nullspace treatment")
            if eligible and want:
                from ..linalg.fdm import FastDiagPoisson

                self.poisson_fdm = fdm = FastDiagPoisson(
                    self.mesh.dxp, self.mesh.periodic, dtype=self.dtype,
                    scale=self.dt,
                    precision=fdm_cfg.get("precision", "highest"),
                    use_fft=bool(fdm_cfg.get("fft", False)))
                if (self.sharding_mesh is not None
                        and bool(fdm_cfg.get("repartition", True))):
                    # transform-axis repartitioning: all-to-all reshard
                    # between per-axis transforms instead of full-grid
                    # all-reduces
                    self.poisson_fdm.set_mesh(self.sharding_mesh)
                # "direct" default: with warm-started, recurrence-residual
                # refinement the direct solve is as robust as CG — the
                # earlier f32 stagnation risk came from judging fresh
                # b - A x residuals at ||b|| scale, fixed in make_fdm_solver
                self._fdm_mode = str(fdm_cfg.get("mode", "direct"))
                if self._fdm_mode == "direct":
                    return None  # direct solver: no Krylov preconditioner

                # CG preconditioner: the exact SPD pseudo-inverse (up to
                # f32 rounding).  Output plain-mean removal keeps the f32
                # CG recurrences from accumulating nullspace drift (same
                # rationale as PoissonMG.preconditioner)
                def M(r):
                    out = fdm.solve(r)
                    return out - jnp.mean(out)

                return M
            from ..linalg.mg import PoissonMG

            mg_params = self.config.get("parameters", {}).get("mg", {}) or {}
            # V(1,1) default: measured ~20% faster end-to-end than V(2,2)
            # at equal converged residuals (CG absorbs the weaker cycle)
            mg_knobs = dict(
                scale=self.dt,
                pre=int(mg_params.get("pre", 1)),
                post=int(mg_params.get("post", 1)),
                omega=float(mg_params.get("omega", 1.0)),
                coarse_sweeps=int(mg_params.get("coarseSweeps", 10)),
                consolidate_below=int(mg_params.get("consolidateBelow",
                                                    4096)))
            self.poisson_mg = PoissonMG(
                self.mesh.dxp, self.mesh.periodic, dtype=self.dtype,
                **mg_knobs)
            if self.sharding_mesh is not None:
                # distributed MG: replicate the tiny coarse levels
                # (redundant coarse solve) instead of sharding them
                self.poisson_mg.set_mesh(self.sharding_mesh)
            # mixed-precision V-cycle (mg: {dtype: bfloat16}): the CG
            # operator and solution stay in the solver dtype — only the
            # preconditioner's coefficient streams and smoother math run
            # in the lower precision, roughly halving the V-cycle's HBM
            # traffic.  Preconditioner accuracy only affects the CG
            # iteration count, not the converged solution.
            lp = mg_params.get("dtype")
            if lp and jnp.dtype(lp) != self.dtype:
                lp_dtype = jnp.dtype(lp)
                self.poisson_mg_lp = PoissonMG(
                    self.mesh.dxp, self.mesh.periodic, dtype=lp_dtype,
                    **mg_knobs)
                if self.sharding_mesh is not None:
                    self.poisson_mg_lp.set_mesh(self.sharding_mesh)
                mg_lp, remove_mean = self.poisson_mg_lp, not self.is_ref_p
                out_dtype = self.dtype

                def M(r):
                    # nullspace means in full precision: a low-precision
                    # sum over the whole grid would be garbage
                    if remove_mean:
                        r = r - jnp.mean(r)
                    out = mg_lp.vcycle(0, r.astype(lp_dtype)).astype(out_dtype)
                    return out - jnp.mean(out) if remove_mean else out

                return M
            return self.poisson_mg.preconditioner(
                remove_mean=not self.is_ref_p)
        diag_p = extract_diagonal(
            self._negA_p, jnp.zeros(self.mesh.shape(Field.P), self.dtype),
            radius=self.bn_order)
        return lambda r: r / diag_p

    # ------------------------------------------------------------------
    # step building blocks, shared with the IBM subclasses
    def _rhs_velocity(self, state):
        """assembleRHSVelocity (navierstokes.cpp:432-521); returns
        (rhs1, updated state)."""
        dt, nu = self.dt, self.nu
        cimp = self.diff_ti.implicit_coeff
        q, p, bcstate = state["q"], state["p"], state["bc"]
        conv, diff = state["conv"], state["diff"]

        gp = self.grad(p)
        rhs1 = tmap(lambda u, g: u / dt - g, q, gp)
        if self.conv_ti.explicit_coeffs:
            conv = (tmap(lambda x: -x, self.convect(q, bcstate)),) + conv[:-1]
            for c, h in zip(self.conv_ti.explicit_coeffs, conv):
                rhs1 = tmap(lambda r, x: r + c * x, rhs1, h)
        if self.diff_ti.explicit_coeffs:
            # L(q, bc) assembled as ONE homogeneous sweep + the O(surface)
            # a1 correction — the inhomogeneous extend form costs a
            # ghost-padded copy per direction (the round-5 3D RHS hotspot)
            lq = tmap(lambda a, b: a + b,
                      self.lap(q, None, homogeneous=True),
                      self.lap.correction(bcstate))
            diff = (tmap(lambda x: nu * x, lq),) + diff[:-1]
            for c, h in zip(self.diff_ti.explicit_coeffs, diff):
                rhs1 = tmap(lambda r, x: r + c * x, rhs1, h)
        # implicit BC correction: update a1, add a_imp * nu * Lbc u
        # (Lbc = L(q, bc) - L(q, hom) = the a1 surface correction alone,
        # with the POST-update_eqs a1 — reference navierstokes.cpp:505)
        bcstate = self.bc.update_eqs(bcstate, q, dt)
        if cimp != 0.0:
            rhs1 = tmap(lambda r, x: r + cimp * nu * x,
                        rhs1, self.lap.correction(bcstate))
        state = dict(state, bc=bcstate, conv=conv, diff=diff)
        return rhs1, state

    def _solve_velocity(self, rhs1, state):
        x0 = state["q"] if self.warm_start else tmap(jnp.zeros_like, state["q"])
        return self.v_solver(rhs1, x0)

    def _rhs_poisson(self, ustar, state):
        """assembleRHSPoisson (navierstokes.cpp:540-563)."""
        rhs2 = self.div(ustar, state["bc"])
        if self.is_ref_p:
            rhs2 = rhs2.reshape(-1).at[0].set(0.0).reshape(rhs2.shape)
        else:
            rhs2 = rhs2 - jnp.mean(rhs2)  # nullspace-consistent RHS
        return rhs2

    def _solve_poisson(self, rhs2, state):
        """solvePoisson (navierstokes.cpp:566-580)."""
        x0 = (state["dP"] if self.warm_start_poisson
              else jnp.zeros_like(state["p"]))
        return self.p_solver(-rhs2, x0)

    def _project_update(self, ustar, dP, state):
        """applyDivergenceFreeVelocity + updatePressure
        (navierstokes.cpp:583-615); returns (q, p, dP)."""
        if not self.is_ref_p:
            dP = dP - jnp.mean(dP)
        qnew = tmap(lambda u, g: u - g, ustar, self.bn(self.grad(dP)))
        return qnew, state["p"] + dP, dP

    def _poisson_project(self, ustar, state):
        """assembleRHSPoisson + solvePoisson + projection + pressure update
        (navierstokes.cpp:540-615); returns (q, p, dP, poisson result)."""
        rhs2 = self._rhs_poisson(ustar, state)
        psol = self._solve_poisson(rhs2, state)
        qnew, pnew, dP = self._project_update(ustar, psol.x, state)
        return qnew, pnew, dP, psol

    def _build_step(self):
        """One time step as a pure state->state function
        (advance, navierstokes.cpp:240-266)."""

        def step(state):
            rhs1, state = self._rhs_velocity(state)
            vsol = self._solve_velocity(rhs1, state)
            qnew, pnew, dP, psol = self._poisson_project(vsol.x, state)
            bcstate = self.bc.update_ghost_values(state["bc"], qnew)
            stats = {"v_iters": vsol.iters, "v_res": vsol.residual,
                     "v_ok": vsol.converged,
                     "p_iters": psol.iters, "p_res": psol.residual,
                     "p_ok": psol.converged}
            return dict(state, q=qnew, p=pnew, bc=bcstate, dP=dP), stats

        return step

    # ------------------------------------------------------------------
    def _profile_phases(self):
        """Ordered (name, fn) phase list reproducing one time step for the
        stage profiler (the reference's PETSc log stages,
        navierstokes.cpp:99-199).  Each fn maps a context dict to
        (context, probe) where probe is a tiny scalar data-dependent on the
        phase's output, so device_get(probe) waits for the phase (see
        utils/profiling.py)."""

        def rhsVelocity(ctx):
            rhs1, state = self._rhs_velocity(ctx["state"])
            return dict(ctx, state=state, rhs1=rhs1), rhs1["u"].ravel()[0]

        def solveVelocity(ctx):
            vsol = self._solve_velocity(ctx["rhs1"], ctx["state"])
            return dict(ctx, ustar=vsol.x), vsol.residual

        def rhsPoisson(ctx):
            rhs2 = self._rhs_poisson(ctx["ustar"], ctx["state"])
            return dict(ctx, rhs2=rhs2), rhs2.ravel()[0]

        def solvePoisson(ctx):
            psol = self._solve_poisson(ctx["rhs2"], ctx["state"])
            return dict(ctx, dP=psol.x), psol.residual

        def update(ctx):
            state = ctx["state"]
            qnew, pnew, dP = self._project_update(ctx["ustar"], ctx["dP"],
                                                  state)
            bc = self.bc.update_ghost_values(state["bc"], qnew)
            state = dict(state, q=qnew, p=pnew, dP=dP, bc=bc)
            return {"state": state}, pnew.ravel()[0]

        return [("rhsVelocity", rhsVelocity),
                ("solveVelocity", solveVelocity),
                ("rhsPoisson", rhsPoisson),
                ("solvePoisson", solvePoisson),
                ("update", update)]

    def profile_stages(self, steps: int = 10, warmup: int = 3,
                       path: str | None = None, repeat: int = 8) -> dict:
        """Per-phase device-time breakdown of the time step; see
        utils/profiling.py.  Writes the stage table to
        logs/stages-<start>.txt (or ``path``) and returns {phase: ms}.
        ``repeat``: in-program amplification per prefix (raise it when
        phases are far below the host round trip)."""
        from ..utils.profiling import profile_stages

        if path is None:
            path = os.path.join(self.logs_dir, f"stages-{self.ite}.txt")
        return profile_stages(self, steps=steps, warmup=warmup, path=path,
                              repeat=repeat)

    # ------------------------------------------------------------------
    def advance(self) -> None:
        self.t += self.dt
        self.ite += 1
        with self.timers.stage("step"):
            self.state, stats = self._step_fn(self.state)
            if self._sync_every_step:
                jax.block_until_ready(self.state)
        self._record_stats(self.ite, stats, 1)

    def advance_chunk(self) -> None:
        """Advance steps_per_dispatch steps in one device dispatch."""
        k = self.steps_per_dispatch
        with self.timers.stage("step"):
            self.state, stats = self._chunk_fn(self.state)
            if self._sync_every_step:
                jax.block_until_ready(self.state)
        self.t += k * self.dt
        self.ite += k
        self._record_stats(self.ite - k + 1, stats, k)

    def _record_stats(self, ite0: int, stats, count: int) -> None:
        """Queue per-step solver stats (stacked along axis 0 when
        count > 1) for the buffered iterations log."""
        self._last_stats = stats
        self._stats_buffer.append((ite0, stats, count))

    def _steps_to_host_event(self) -> int:
        """Steps until the host next needs state (save / restart / probe
        monitor / end of run) — the window advance_chunk may fill."""
        nexts = [self.nstart + self.nt - self.ite]
        intervals = [self.nsave, self.nrestart]
        intervals += [p.n_monitor for p in getattr(self, "probes", [])]
        for interval in intervals:
            if interval > 0:
                nexts.append(interval - self.ite % interval)
        return min(nexts)

    def finished(self) -> bool:
        return self.ite >= self.nstart + self.nt

    def _due(self, interval: int) -> bool:
        """True on steps that are a multiple of ``interval`` (never when
        it is 0: that output is off)."""
        return interval > 0 and self.ite % interval == 0

    # ------------------------------------------------------------------
    def _solution_fields(self) -> dict:
        out = {VEL_NAMES[c]: self.state["q"][VEL_NAMES[c]]
               for c in range(self.mesh.dim)}
        out["p"] = self.state["p"]
        return out

    def _snapshot_path(self) -> str:
        return os.path.join(self.output_dir, f"{self.ite:07d}.h5")

    def io_initial_data(self) -> None:
        """Write step-0 snapshot or read restart data
        (navierstokes.cpp:207-237)."""
        if self.ite == 0:
            if self.nsave > 0:
                self.write_solution_hdf5(self._snapshot_path())
        else:
            self.read_restart_data_hdf5(self._snapshot_path())

    def write_solution_hdf5(self, path: str) -> None:
        pio.write_solution(path, jax.block_until_ready(self._solution_fields()))
        pio.write_time(path, self.t)

    def write_restart_data_hdf5(self, path: str) -> None:
        if not os.path.isfile(path):
            self.write_solution_hdf5(path)
        pio.write_restart_histories(
            path, self.mesh.dim,
            [jax.block_until_ready(h) for h in self.state["conv"]],
            [jax.block_until_ready(h) for h in self.state["diff"]],
            extra=self._restart_extra())

    def _restart_extra(self) -> dict:
        # native extensions to the reference layout (reference readers
        # ignore the extra groups): dP restores the warm-start state, and
        # the per-face BC ghost state (a1/value) makes restarts exact even
        # with convective BCs — the reference only re-initializes those and
        # carries a TODO about it (navierstokes.cpp:742)
        return dict({"dP": self.state["dP"]}, **self._bc_restart_extra())

    def _bc_restart_extra(self) -> dict:
        """Per-face BC ghost state (a1/value) for exact restarts —
        shared with subclasses that replace the rest of the extras."""
        extra = {}
        for key, st in self.state["bc"].items():
            extra[f"bc_{key}_a1"] = st["a1"]
            extra[f"bc_{key}_value"] = st["value"]
        return extra

    def read_restart_data_hdf5(self, path: str) -> None:
        names = [VEL_NAMES[c] for c in range(self.mesh.dim)] + ["p"]
        data = pio.read_solution(path, names)
        q = {n: jnp.asarray(data[n], self.dtype) for n in names if n != "p"}
        self.state["q"] = q
        self.state["p"] = jnp.asarray(data["p"], self.dtype)
        self.t = pio.read_time(path)
        shapes = {VEL_NAMES[c]: self.mesh.shape(Field(c))
                  for c in range(self.mesh.dim)}
        conv, diff, extra = pio.read_restart_histories(
            path, self.mesh.dim, shapes, len(self.state["conv"]),
            len(self.state["diff"]), extra_names=tuple(self._restart_extra()))
        self.state["conv"] = tuple(
            {k: jnp.asarray(v, self.dtype) for k, v in h.items()} for h in conv)
        self.state["diff"] = tuple(
            {k: jnp.asarray(v, self.dtype) for k, v in h.items()} for h in diff)
        # default ghost state (what the reference does, navierstokes.cpp:742)
        # — then _read_restart_extra overrides it with the saved a1/value
        # when the file carries them, making convective-BC restarts exact
        self.state["bc"] = self.bc.init_state(q, self.dtype)
        self._read_restart_extra(extra)

    def _read_restart_extra(self, extra: dict) -> None:
        if "dP" in extra:
            self.state["dP"] = jnp.asarray(
                extra["dP"].reshape(self.mesh.shape(Field.P)), self.dtype)
        self._restore_bc_extra(extra)

    def _restore_bc_extra(self, extra: dict) -> None:
        bcstate = dict(self.state["bc"])
        for key, st in bcstate.items():
            a1 = extra.get(f"bc_{key}_a1")
            val = extra.get(f"bc_{key}_value")
            if a1 is not None and val is not None:
                bcstate[key] = {
                    "a1": jnp.asarray(a1.reshape(st["a1"].shape), self.dtype),
                    "value": jnp.asarray(val.reshape(st["value"].shape),
                                         self.dtype)}
        self.state["bc"] = bcstate

    # ------------------------------------------------------------------
    def write(self) -> None:
        """Per-step outputs (write, navierstokes.cpp:269-308)."""
        with self.timers.stage("write"):
            self.write_lin_solvers_info()
            if self._due(self.nsave):
                self.write_solution_hdf5(self._snapshot_path())
                self.timers.dump(os.path.join(self.logs_dir,
                                              f"{self.ite:07d}.log"))
            if self._due(self.nrestart):
                self.write_restart_data_hdf5(self._snapshot_path())
        self.monitor_probes()

    def _iter_log_stats(self, s: dict) -> list[tuple]:
        return [(s["v_iters"], s["v_res"]), (s["p_iters"], s["p_res"])]

    def write_lin_solvers_info(self) -> None:
        """iterations-<start>.txt lines (navierstokes.cpp:766-794).

        Stats stay device-resident and are flushed in one batched transfer
        at save points, so per-step logging never stalls the async step
        pipeline with a host sync."""
        if self._due(self.nsave) or self.finished():
            self._flush_iter_log()

    _SOLVER_NAMES = {"v": "velocity", "p": "poisson", "f": "forces"}

    def _flush_iter_log(self) -> None:
        if not self._stats_buffer:
            return
        items = jax.device_get(self._stats_buffer)
        self._stats_buffer = []
        failures = []
        for ite0, s, count in items:
            for j in range(count):
                sj = (s if count == 1
                      else {k: v[j] for k, v in s.items()})
                cols = [str(ite0 + j)]
                for iters, res in self._iter_log_stats(sj):
                    cols.append(f"{int(iters)}\t{float(res):e}")
                self._iter_log.write("\t".join(cols) + "\n")
                for key, val in sj.items():
                    if key.endswith("_ok") and not bool(val):
                        pre = key[:-3]
                        failures.append(
                            (self._SOLVER_NAMES.get(pre, pre), ite0 + j,
                             int(sj[f"{pre}_iters"]),
                             float(sj[f"{pre}_res"])))
        self._iter_log.flush()
        if failures and self.divergence_policy != "ignore":
            name, step, iters, res = failures[0]
            msg = (f"{name} solver diverged at time step {step}: "
                   f"{iters} iterations, residual {res:e} "
                   f"(+{len(failures) - 1} more failure(s); see "
                   f"{self.iter_log_path})")
            if self.divergence_policy == "abort":
                from ..linalg import SolverDivergedError

                raise SolverDivergedError(msg)
            import sys

            print(f"WARNING: {msg}", file=sys.stderr)

    def _create_probes(self, config: dict) -> None:
        """Probe creation with output-dir path prepending
        (navierstokes.cpp:167-177)."""
        from ..io.probes import create_probe

        self.probes = []
        for node in config.get("probes", []) or []:
            node = dict(node)
            if not os.path.isabs(node.get("path", "")):
                node["path"] = os.path.join(self.output_dir, node["path"])
            self.probes.append(create_probe(node, self.mesh, self.bc))

    def monitor_probes(self) -> None:
        """monitorProbes (navierstokes.cpp:840-856)."""
        if not self.probes:
            return
        with self.timers.stage("monitor"):
            fields = dict(self._solution_fields())
            fields["_bcstate"] = self.state["bc"]
            for probe in self.probes:
                probe.monitor(fields, self.ite, self.t)

    # ------------------------------------------------------------------
    def run(self, progress: bool = False) -> None:
        """main-loop convenience (applications/navierstokes/main.cpp:45-78).
        Steps run in steps_per_dispatch chunks wherever no host event
        (save / restart / probe) falls inside the chunk.

        ``progress`` prints a line after every chunk and at each save and
        the end, with the wall time per step since the previous line
        (the device is synced first, so the rate is the device's); each
        (first step, last step, ms/step) also lands in ``step_rates``."""
        import time

        self.io_initial_data()
        self.step_rates = []
        t_last, ite_last = time.perf_counter(), self.ite
        try:
            while not self.finished():
                chunked = (self._chunk_fn is not None
                           and self._steps_to_host_event()
                           >= self.steps_per_dispatch)
                if chunked:
                    self.advance_chunk()
                else:
                    self.advance()
                self.write()
                if progress and (chunked or self._due(self.nsave)
                                 or self.finished()):
                    jax.block_until_ready(self.state)
                    now = time.perf_counter()
                    ms = (now - t_last) / (self.ite - ite_last) * 1e3
                    self.step_rates.append((ite_last + 1, self.ite, ms))
                    print(f"[time step {self.ite}] t = {self.t:.6g} "
                          f"({ms:.4g} ms/step over steps "
                          f"{ite_last + 1}-{self.ite})")
                    t_last, ite_last = now, self.ite
        finally:
            # crash-safe logging: a mid-run exception (including a solver-
            # divergence abort) still lands every buffered per-step record
            # on disk — the reference writes its logs unbuffered each step
            self.flush_logs()

    def flush_logs(self) -> None:
        """Flush all buffered per-step logs (iterations, forces) to disk.
        Buffers are cleared before any divergence abort re-raises, so a
        second call after an exception is a no-op."""
        try:
            self._flush_iter_log()
        finally:
            flush_forces = getattr(self, "_flush_forces", None)
            if flush_forces is not None:
                flush_forces()

    def close(self) -> None:
        self._flush_iter_log()
        if self._iter_log and not self._iter_log.closed:
            self._iter_log.close()
        for probe in getattr(self, "probes", []):
            if hasattr(probe, "close"):
                probe.close()
