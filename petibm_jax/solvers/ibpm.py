"""Fully-coupled immersed-boundary projection method (Taira & Colonius 2007).

JAX re-design of the reference's IBPMSolver
(reference: applications/ibpm/ibpm.{h,cpp}).  The reference appends the
Lagrangian forces to the pressure unknown via nested matrices
([G, -H] and [D; E] converted to AIJ, ibpm.cpp:100-203) and solves the
modified Poisson system with the same Krylov machinery.  Here the combined
unknown is the pytree {"p": pressure, "f": forces} and the block operator

    M [p, f] = [ D B_N (G p - H f),  E B_N (G p - H f) ]

is applied matrix-free (G/D are stencils, E/H delta windows).  M is
symmetric negative semidefinite (D^T = -vol*G, E = Delta*vol, H = Delta^T,
and vol*B_N is symmetric), with nullspace = constant in the pressure block
only (setNullSpace, ibpm.cpp:242-283), so CG applies exactly as in the
reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import solver_config
from ..ibm.body import BodyPack
from ..ibm.interp import exact_dot as _dot, make_delta_op
from ..linalg import extract_diagonal, make_solver
from ..types import Field
from ._forceslog import ForcesLogMixin
from .navierstokes import NavierStokesSolver

tmap = jax.tree_util.tree_map


class IBPMSolver(ForcesLogMixin, NavierStokesSolver):
    _skip_base_poisson = True  # the {p, f} block system replaces p_solver

    def _extra_init(self, config: dict) -> None:
        self.bodies = BodyPack(config, self.mesh)
        if self.bodies.n_bodies == 0:
            raise ValueError("IBPM requires at least one body")
        params = config.get("parameters", {})
        kernel = params.get("delta", "ROMA_ET_AL_1999")
        self.delta = make_delta_op(
            self.mesh, kernel, self.dtype, n_pts=self.bodies.n_pts,
            engine=params.get("deltaEngine", "auto"))
        self.state["f"] = jnp.zeros((self.bodies.n_pts, self.mesh.dim),
                                    self.dtype)
        self._win = self.delta.windows(
            jnp.asarray(self.bodies.all_coords(), self.dtype))
        self._create_coupled_poisson(config)
        self.state["dPhi"] = {"p": jnp.zeros_like(self.state["p"]),
                              "f": jnp.zeros_like(self.state["f"])}

    # ------------------------------------------------------------------
    def _create_coupled_poisson(self, config: dict) -> None:
        """The modified Poisson operator and its solver, replacing the
        base class's pressure-only system (createOperators, ibpm.cpp:184-197)."""
        delta, win, bn = self.delta, self._win, self.bn
        grad, div = self.grad, self.div
        popts = solver_config(config, "poisson")
        self.is_ref_p = popts.get("backend") == "GPU"

        def G_combined(phi):
            gp = grad(phi["p"])
            hf = delta.spread(phi["f"], win)
            return tmap(lambda a, b: a - b, gp, hf)

        def M(phi):
            w = bn(G_combined(phi))
            return {"p": div(w, None, homogeneous=True),
                    "f": delta.interpolate(w, win)}

        if self.is_ref_p:
            def A_p(phi):
                pflat = phi["p"].reshape(-1)
                phi0 = dict(phi, p=pflat.at[0].set(0.0).reshape(phi["p"].shape))
                y = M(phi0)
                yp = y["p"].reshape(-1).at[0].set(pflat[0])
                return dict(y, p=yp.reshape(y["p"].shape))
        else:
            A_p = M

        def negM(phi):
            return tmap(lambda x: -x, A_p(phi))

        self._G_combined = G_combined

        # Direct Schur-complement solve (stationary bodies, BN=1): the
        # pressure block A_pp = -D B1 G has an exact fast-diagonalization
        # inverse, so the {p, f} block system is directly solvable via a
        # setup-time dense force-space Schur complement — no outer Krylov
        # at all (the reference iterates AmgX/KSP on the nested system
        # every step, ibpm.cpp:100-203).  Opt out with
        # parameters.coupledDirect: false.
        params = config.get("parameters", {})
        pc = popts.get("pc", "mg")
        use_direct = (self.bn_order == 1
                      and not self.delta.windowed
                      and self.sharding_mesh is None
                      and pc in ("mg", "fdm")
                      and bool(params.get("coupledDirect", True)))
        if use_direct:
            if self.is_ref_p:
                # pinned-pressure (AmgX-parity) backend: the pinned
                # system is exactly the projected Schur solve with a
                # compatibility shift + gauge fix (see
                # _build_schur_solver's pinned adapter) — the outer-CG
                # path stalls on this system at scale (the 450^2 GPU
                # case diverged at 20000 iterations)
                from ..linalg.fdm import FastDiagPoisson, fdm_config

                fdm_cfg = fdm_config(params)
                self.poisson_fdm = FastDiagPoisson(
                    self.mesh.dxp, self.mesh.periodic,
                    dtype=self.dtype, scale=self.dt,
                    precision=fdm_cfg.get("precision", "highest"))
                self._coupled_solver = self._build_schur_solver(negM, popts)
                return
            p_pre = self._make_poisson_pc(popts)
            if self.poisson_fdm is not None:
                self._coupled_solver = self._build_schur_solver(negM, popts)
                return
            # FDM unavailable (fdm: false) — fall through to the CG path
            self._finish_cg_solver(config, popts, negM, p_pre)
            return
        self._finish_cg_solver(config, popts, negM, None)

    # ------------------------------------------------------------------
    def _build_schur_solver(self, negM, popts: dict):
        """Setup-time block elimination of the coupled system.

        With A_pp = -D B1 G (exactly FDM-invertible), A_pf = D B1 H,
        A_fp = -E B1 G, A_ff = E B1 H, the dense force-space Schur
        complement

            S = A_ff - A_fp A_pp^+ A_pf = E B1 H + (E B1 G) A_pp^+ (D B1 H)

        is formed column-by-column by running the FDM solver over the
        N*dim columns of D B1 H (batched matmuls), inverted once on the
        host in float64, and each per-step solve becomes: one FDM pressure
        solve, two small dense matvecs, one FDM correction solve.  The
        constant-pressure nullspace is consistent with this elimination
        because every A_pf column is plain-sum-free (H f has compact
        interior support, so sum(D B1 H f) telescopes to zero boundary
        flux) and A_fp annihilates constants (G const = 0).  Wrapped in
        make_fdm_solver for true-residual refinement with KSP stopping
        semantics (iters counts refinement passes)."""
        import numpy as np

        from ..linalg.fdm import make_fdm_solver

        fdm = self.poisson_fdm
        delta, win, bn = self.delta, self._win, self.bn
        grad, div = self.grad, self.div
        N, dim, dtype = self.bodies.n_pts, self.mesh.dim, self.dtype
        m = N * dim

        def col(e_flat):
            f = e_flat.reshape(N, dim)
            h = bn(delta.spread(f, win))                 # B1 H e
            a = delta.interpolate(h, win)                # E B1 H e
            y = fdm.solve(div(h, None, homogeneous=True))  # A_pp^+ D B1 H e
            s2 = delta.interpolate(bn(grad(y)), win)     # E B1 G y
            return (a + s2).reshape(-1)

        # chunked vmap: cap the live per-chunk field batch near 128 MB
        ncells = 1
        for s in self.mesh.shape(Field.P):
            ncells *= s
        chunk = max(1, min(64, (1 << 25) // max(ncells, 1)))
        pad = (-m) % chunk
        eye = jnp.eye(m, dtype=dtype)
        if pad:
            eye = jnp.concatenate(
                [eye, jnp.zeros((pad, m), dtype)], axis=0)
        cols = jax.lax.map(jax.vmap(col), eye.reshape(-1, chunk, m))
        S = np.asarray(cols.reshape(-1, m)[:m], np.float64).T
        # the coupled operator is symmetric (tested by
        # test_ibpm_coupled_operator_symmetric), hence so is S; averaging
        # halves the f32 column-estimation noise before inversion
        S = 0.5 * (S + S.T)
        Sinv = jnp.asarray(np.linalg.inv(S), dtype)

        class _Schur:
            def solve(self, r):
                y = fdm.solve(r["p"])
                g = r["f"].reshape(-1) + delta.interpolate(
                    bn(grad(y)), win).reshape(-1)
                df = _dot(Sinv, g)
                f2 = df.reshape(N, dim)
                dp = fdm.solve(r["p"] - div(
                    bn(delta.spread(f2, win)), None, homogeneous=True))
                return {"p": dp, "f": f2}

        schur = _Schur()
        if self.is_ref_p:
            # pinned-dof adapter: the pinned operator replaces row/col 0
            # of the pressure block with the identity (A_p above).  Its
            # exact inverse in terms of the projected solve: the pinned
            # solution x has x_p[0] = r_p[0] =: s, and x' = x - s*e0
            # solves M x' = r + beta*e0 on rows != 0 where
            # beta = -sum_{i!=0} r_p[i] makes the rhs sum-free (range of
            # M); the gauge is fixed by shifting the projected solution
            # so x'_p[0] = 0.  Exact up to f32 — the outer solver's
            # true-residual check covers the rest.
            inner = schur

            class _PinnedSchur:
                @staticmethod
                def solve(r):
                    rp = r["p"].reshape(-1)
                    s = rp[0]
                    beta = s - jnp.sum(rp)  # -sum over i != 0
                    r2 = dict(r, p=rp.at[0].set(beta).reshape(r["p"].shape))
                    out = inner.solve(r2)
                    op = out["p"].reshape(-1)
                    op = (op - op[0]).at[0].set(s)
                    return dict(out, p=op.reshape(r["p"].shape))

            schur = _PinnedSchur()
        mode = str(self.config.get("parameters", {}).get(
            "coupledMode", "pcg"))
        if mode == "direct":
            # plain refinement: cheapest when it converges, but its f32
            # recurrence floor sits near ~1e-5 * ||intermediates|| — at
            # 986^2 (re3000) that lands *above* atol 1e-6 and the
            # stagnation exit trips the divergence policy.  The default
            # wraps the same exact inverse as a CG preconditioner: the
            # Krylov minimization reaches the tolerance in 1-3 iterations
            # at essentially the same cost per step.
            return make_fdm_solver(schur, negM, popts)

        if self.is_ref_p:
            # the pinned system is nonsingular: no nullspace hygiene, and
            # mean removal would destroy the pinned gauge
            M_pre = schur.solve
        else:
            def M_pre(r):
                out = schur.solve(r)
                return {"p": out["p"] - jnp.mean(out["p"]), "f": out["f"]}

        from ..linalg import make_solver as _mk
        return _mk(negM, popts, M=M_pre)

    # ------------------------------------------------------------------
    def _finish_cg_solver(self, config: dict, popts: dict, negM,
                          p_pre) -> None:
        """The outer-CG coupled solver (pinned-pressure parity mode, BN>1,
        windowed large bodies, sharded runs, and coupledDirect: false)."""
        delta, win, bn = self.delta, self._win, self.bn
        grad, div = self.grad, self.div

        # pressure block: MG V-cycle or probed-diagonal Jacobi; force block:
        # analytic order-1 diag (diag(E B1 H) = dt * prod_d sum_k wd*wv)
        pc = popts.get("pc", "mg")
        if pc in ("mg", "fdm"):
            if p_pre is None:
                p_pre = self._make_poisson_pc(popts)
            if p_pre is None and self.poisson_fdm is not None:
                # fast-diagonalization pseudo-inverse (linalg/fdm.py): the
                # *exact* SPD inverse of the pressure block -D B1 G, a
                # strictly stronger block preconditioner than a V-cycle
                # (only the E/H force coupling remains for the outer CG).
                # Output plain-mean removal matches the base class's pcg
                # wrapper: on stretched grids the FDM output is only
                # W-orthogonal to the constant mode, and f32 CG recurrences
                # otherwise accumulate nullspace drift
                fdm_p = self.poisson_fdm

                def p_pre(r, fdm_p=fdm_p):
                    out = fdm_p.solve(r)
                    return out - jnp.mean(out)
        else:
            diag_p = extract_diagonal(
                lambda p: -self.div(bn(grad(p)), None, homogeneous=True),
                jnp.zeros(self.mesh.shape(Field.P), self.dtype),
                radius=self.bn_order)
            p_pre = lambda r: r / diag_p
        # force block: for BN=1 with factor-engine windows, invert the
        # dense per-component (N, N) EBNH blocks at setup (diag(E B1 H)
        # Jacobi left the outer CG at ~500 iterations/step on the K&L
        # cylinder cases; the exact block inverse leaves only the p-f
        # cross coupling to CG).  Windowed-engine (large) bodies and
        # BN>1 keep the analytic diagonal.
        dense_f = (self.bn_order == 1 and not self.delta.windowed)
        if dense_f:
            import numpy as np

            from ..ibm.interp import dense_ebnh_blocks

            mats = dense_ebnh_blocks(win, self.mesh.dim, self.dt,
                                     self.dtype)
            inv_f = [jnp.asarray(
                np.linalg.inv(np.asarray(m, np.float64)), self.dtype)
                for m in mats]

            def M_block(r):
                rf = r["f"]
                df = jnp.stack(
                    [_dot(inv_f[c], rf[:, c]) for c in range(self.mesh.dim)],
                    axis=1)
                return {"p": p_pre(r["p"]), "f": df}
        else:
            cols = []
            for c in range(self.mesh.dim):
                w = win[c]
                prod = None
                for d in range(self.mesh.dim):
                    s = jnp.sum(w["sd"][d] * w["sv"][d], axis=1)
                    prod = s if prod is None else prod * s
                cols.append(self.dt * prod)
            diag_f = jnp.maximum(jnp.stack(cols, axis=1), 1e-30)

            def M_block(r):
                return {"p": p_pre(r["p"]), "f": r["f"] / diag_f}

        M_pre = M_block if popts.get("pc") != "none" else None
        self._coupled_solver = make_solver(negM, popts, M=M_pre)

    # ------------------------------------------------------------------
    def _build_step(self):
        def step(state):
            # momentum RHS: the reference applies the COMBINED gradient
            # [G, -H] to the accumulated phi = (p, f) in its inherited
            # assembleRHSVelocity (createOperators swaps this->G for the
            # nested operator, ibpm.cpp:164-169), i.e. rhs1 gets
            # -G p + H f.  _rhs_velocity supplies the -G p part; add the
            # spread accumulated force.  Without it every coupled solve
            # returns the FULL force, which then wrongly accumulates
            # (caught by the Re=550 Cd(t)-curve validation).
            rhs1, state = self._rhs_velocity(state)
            hf = self.delta.spread(state["f"], self._win)
            rhs1 = tmap(lambda r, x: r + x, rhs1, hf)
            vsol = self._solve_velocity(rhs1, state)
            ustar = vsol.x

            # combined Poisson RHS: [D u* + Dbc ; E u*]
            # (assembleRHSPoisson, ibpm.cpp:286-313)
            rhs_p = self.div(ustar, state["bc"])
            rhs_f = self.delta.interpolate(ustar, self._win)
            if self.is_ref_p:
                rhs_p = rhs_p.reshape(-1).at[0].set(0.0).reshape(rhs_p.shape)
            else:
                rhs_p = rhs_p - jnp.mean(rhs_p)
            rhs = {"p": -rhs_p, "f": -rhs_f}

            if self.warm_start_poisson:
                phi0 = state["dPhi"]
            else:
                phi0 = {"p": jnp.zeros_like(state["p"]),
                        "f": jnp.zeros_like(state["f"])}
            psol = self._coupled_solver(rhs, phi0)
            dphi = psol.x
            if not self.is_ref_p:
                dphi = dict(dphi, p=dphi["p"] - jnp.mean(dphi["p"]))

            # projection u -= B_N (G dp - H df); phi += dphi
            qnew = tmap(lambda u, g: u - g, ustar,
                        self.bn(self._G_combined(dphi)))
            bcstate = self.bc.update_ghost_values(state["bc"], qnew)
            fnew = state["f"] + dphi["f"]
            # forces ride along in the stats stream so chunked dispatches
            # (stepsPerDispatch > 1) still log them per step
            stats = {"v_iters": vsol.iters, "v_res": vsol.residual,
                     "v_ok": vsol.converged,
                     "p_iters": psol.iters, "p_res": psol.residual,
                     "p_ok": psol.converged,
                     "f": fnew}
            return dict(state, q=qnew, p=state["p"] + dphi["p"],
                        f=fnew, bc=bcstate, dPhi=dphi), stats

        return step

    # ------------------------------------------------------------------
    def _profile_phases(self):
        """Stage list for the coupled solver: the combined {p, f} system
        replaces the rhsPoisson/solvePoisson stages."""

        def rhsVelocity(ctx):
            rhs1, state = self._rhs_velocity(ctx["state"])
            hf = self.delta.spread(state["f"], self._win)
            rhs1 = tmap(lambda r, x: r + x, rhs1, hf)
            return dict(ctx, state=state, rhs1=rhs1), rhs1["u"].ravel()[0]

        def solveVelocity(ctx):
            vsol = self._solve_velocity(ctx["rhs1"], ctx["state"])
            return dict(ctx, ustar=vsol.x), vsol.residual

        def rhsPoisson(ctx):
            state, ustar = ctx["state"], ctx["ustar"]
            rhs_p = self.div(ustar, state["bc"])
            rhs_f = self.delta.interpolate(ustar, self._win)
            if self.is_ref_p:
                rhs_p = rhs_p.reshape(-1).at[0].set(0.0).reshape(rhs_p.shape)
            else:
                rhs_p = rhs_p - jnp.mean(rhs_p)
            rhs = {"p": -rhs_p, "f": -rhs_f}
            return dict(ctx, rhs=rhs), rhs_p.ravel()[0]

        def solvePoisson(ctx):
            state = ctx["state"]
            phi0 = (state["dPhi"] if self.warm_start_poisson
                    else {"p": jnp.zeros_like(state["p"]),
                          "f": jnp.zeros_like(state["f"])})
            psol = self._coupled_solver(ctx["rhs"], phi0)
            return dict(ctx, dphi=psol.x), psol.residual

        def update(ctx):
            state, dphi = ctx["state"], ctx["dphi"]
            if not self.is_ref_p:
                dphi = dict(dphi, p=dphi["p"] - jnp.mean(dphi["p"]))
            qnew = tmap(lambda u, g: u - g, ctx["ustar"],
                        self.bn(self._G_combined(dphi)))
            bc = self.bc.update_ghost_values(state["bc"], qnew)
            state = dict(state, q=qnew, p=state["p"] + dphi["p"],
                         f=state["f"] + dphi["f"], bc=bc, dPhi=dphi)
            return {"state": state}, state["p"].ravel()[0]

        return [("rhsVelocity", rhsVelocity),
                ("solveVelocity", solveVelocity),
                ("rhsPoisson", rhsPoisson),
                ("solvePoisson", solvePoisson),
                ("update", update)]

    # ------------------------------------------------------------------
    def _restart_extra(self) -> dict:
        # the per-face BC ghost state must ride along too (the base class
        # saves it; overriding wholesale silently dropped it and made
        # convective-BC restarts inexact — caught by
        # tests/test_ibm.py::test_ibpm_coupled_restart_exact)
        return dict({"force": self.state["f"],
                     "dP": self.state["dPhi"]["p"],
                     "dF": self.state["dPhi"]["f"]},
                    **self._bc_restart_extra())

    def _read_restart_extra(self, extra: dict) -> None:
        if "force" in extra:
            self.state["f"] = jnp.asarray(
                extra["force"].reshape(self.bodies.n_pts, self.mesh.dim),
                self.dtype)
        if "dP" in extra and "dF" in extra:
            from ..types import Field

            self.state["dPhi"] = {
                "p": jnp.asarray(extra["dP"].reshape(self.mesh.shape(Field.P)),
                                 self.dtype),
                "f": jnp.asarray(
                    extra["dF"].reshape(self.bodies.n_pts, self.mesh.dim),
                    self.dtype)}
        self._restore_bc_extra(extra)

