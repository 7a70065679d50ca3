"""GN-SQP / RTI trajectory optimizer — the JAX replacement for acados+HPIPM.

One SQP iteration (all inside a single jit, batched via vmap / shard_map):

  1. vmapped linearization of the stage residual stack over the horizon
     (jacfwd — one jvp graph per node, no symbolic codegen),
  2. Riccati backward sweep over the horizon (lax.scan of 36/30-dim blocks;
     dynamics A/B are CONSTANT because the shooting dynamics are exactly
     linear in the Euler chart — see ocp/problem.py),
  3. affine forward rollout,
  4. PARALLEL line search: all step sizes evaluated simultaneously via vmap,
     best-merit candidate selected (replaces HPIPM's sequential inner loop).

Because the equality dynamics are linear, a full step (alpha=1) is exactly
multiple-shooting feasible: defects scale as (1-alpha) analytically, which
the merit function exploits.

Reference counterparts: SQP outer loop + warm-start shift
(`mpc_controller/utils/solver.py:290-342,396-429`), first-solve boost
(`mpc.py:464-473`), RTI steady state (`mpc_opt.py:25-27`).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models import dynamics as dyn
from ..mpc.config import MPCCostConfig, MPCOptConfig, check_solver_modes
from ..ocp.problem import (
    NC_CONE,
    NC_INEQ,
    NC_PATCH,
    NC_TORQUE,
    NU,
    NX,
    OCPParams,
    Weights,
    dynamics_matrices,
    dynamics_step,
    ineq_values,
    make_weights,
    split_state,
    stage_residual,
    terminal_residual,
)
from ..robots.spec import RobotSpec


class SolveStats(NamedTuple):
    cost: jax.Array          # final GN cost (0.5 ||r||^2 summed)
    defect: jax.Array        # max |defect| after the last accepted step
    step_norm: jax.Array     # |delta| of last SQP step
    alpha: jax.Array         # last accepted step size
    viol: jax.Array          # max scale-normalized inequality violation
    qp_iters: jax.Array      # inner QP (AL) iterations of the last SQP step
    sqp_iters: jax.Array     # outer SQP iterations executed (early stop at
                             # step_norm <= nlp_tol; the warm-start metric)


class Solution(NamedTuple):
    X: jax.Array             # (N+1, 36)
    U: jax.Array             # (N, 30)
    stats: SolveStats
    lam_ineq: jax.Array      # (N, NC_INEQ) annealed AL hinge shifts (for
                             # dual warm starts across replans)
    r_eq: jax.Array          # (N, 18) bare equality rows at the solution —
                             # pass to update_multipliers(r_eq=...) to skip
                             # its FK/RNEA evaluation (shared with the
                             # inner loop's dual launch)

    @property
    def q(self):
        return self.X[:, :18]

    @property
    def v(self):
        return self.X[:, 18:]

    @property
    def a(self):
        return self.U[:, :18]

    @property
    def f(self):
        return self.U[:, 18:NU].reshape(self.U.shape[0], 4, 3)

    def dt_sol(self, dt_nominal):
        """Per-node durations: the optimized 31st input when present, else
        the nominal schedule (reference solver.py:423-427)."""
        if self.U.shape[-1] > NU:
            return self.U[:, NU]
        return dt_nominal


def _stage_residual_z(spec, w, z, cnt, peak, plane, cnt_loc, patch, restrict,
                      base_ref, joint_ref, step_h, lam=None, lam_ineq=None,
                      include_torque=True):
    x, u = z[:NX], z[NX:]
    return stage_residual(spec, w, x, u, cnt, peak, plane, cnt_loc, patch,
                          restrict, base_ref, joint_ref, step_h, lam_k=lam,
                          lam_ineq_k=lam_ineq, include_torque=include_torque)


def _linearize_stages(spec, w, X, U, p: OCPParams, include_torque: bool = False):
    """Vectorized residuals + Jacobians for nodes 0..N-1.

    By default the torque-limit hinge is excluded here (inexact-SQP QP) and
    enforced through the merit function only — see stage_residual docs.
    """
    N = U.shape[0]
    Z = jnp.concatenate([X[:-1], U], axis=1)  # (N, NX+NU)

    def res_one(z, cnt, peak, plane, cnt_loc, patch, lam, lami):
        return _stage_residual_z(
            spec, w, z, cnt, peak, plane, cnt_loc, patch,
            p.restrict, p.base_ref, p.joint_ref, p.step_height, lam, lami,
            include_torque=include_torque,
        )

    def res_and_jac(z, cnt, peak, plane, cnt_loc, patch, lam, lami):
        r = res_one(z, cnt, peak, plane, cnt_loc, patch, lam, lami)
        J = jax.jacfwd(res_one)(z, cnt, peak, plane, cnt_loc, patch, lam, lami)
        return r, J

    cnt_n = p.cnt[:, :N].T        # (N, 4)
    peak_n = p.peak[:, :N].T
    plane_n = p.plane_point[:, :N].transpose(1, 0, 2)   # (N, 4, 3)
    loc_n = p.cnt_loc[:, :N].transpose(1, 0, 2)
    patch_n = p.patch_radius[:, :N].T                   # (N, 4)
    r, J = jax.vmap(res_and_jac)(Z, cnt_n, peak_n, plane_n, loc_n, patch_n,
                                 p.lam_eq, p.lam_ineq)
    return r, J[:, :, :NX], J[:, :, NX:]


def _linearize_terminal(spec, w, xN, p: OCPParams):
    def res(x):
        return terminal_residual(spec, w, x, p.peak[:, -1], p.base_ref_e, p.joint_ref, p.step_height)

    r = res(xN)
    J = jax.jacfwd(res)(xN)
    return r, J


def _riccati_solve(A, B, Q, R, M, qx_vec, ru_vec, P_N, p_N, defects, lm_reg):
    """Backward sweep + gain computation. Returns (K, kff) per node.

    A (NX,NX) or (N,NX,NX); B (NX,NU) or (N,NX,NU) — per-node dynamics are
    used by the time-optimization mode. Q (N,NX,NX); R (N,NU,NU);
    M (N,NX,NU); qx_vec (N,NX); ru_vec (N,NU); defects (N,NX) with
    x_{k+1} = A_k x_k + B_k u_k + d_k in delta coordinates.
    """
    N = Q.shape[0]
    if A.ndim == 2:
        A = jnp.broadcast_to(A[None], (N,) + A.shape)
    if B.ndim == 2:
        B = jnp.broadcast_to(B[None], (N,) + B.shape)
    eyeu = jnp.eye(B.shape[-1], dtype=B.dtype)

    def step(carry, inp):
        P, pvec = carry
        Ak, Bk, Qk, Rk, Mk, qk, rk, dk = inp
        PA = P @ Ak
        PB = P @ Bk
        Qxx = Qk + Ak.T @ PA
        Quu = Rk + Bk.T @ PB + lm_reg * eyeu
        Qux = Mk.T + Bk.T @ PA
        Pd = P @ dk + pvec
        qx = qk + Ak.T @ Pd
        qu = rk + Bk.T @ Pd
        L = jnp.linalg.cholesky(Quu)
        K = -jax.scipy.linalg.cho_solve((L, True), Qux)
        kff = -jax.scipy.linalg.cho_solve((L, True), qu)
        P_new = Qxx + Qux.T @ K
        P_new = 0.5 * (P_new + P_new.T)
        p_new = qx + Qux.T @ kff
        return (P_new, p_new), (K, kff)

    (_, _), (K, kff) = jax.lax.scan(
        step, (P_N, p_N), (A, B, Q, R, M, qx_vec, ru_vec, defects), reverse=True
    )
    return K, kff


def _riccati_solve_structured(h, Q, R, M, qx_vec, ru_vec, P_N, p_N, defects,
                              lm_reg):
    """Backward sweep specialized to the constant double-integrator dynamics
    A = [[I, hI], [0, I]], B = [[h^2/2 I_a], [h I_a]] (force columns of B are
    zero — forces act through the residuals, not the shooting map).

    Every product with A/B collapses to block scale-adds of P's column/row
    blocks, eliminating the five dense 36x36 matmuls per node of the generic
    sweep (`_riccati_solve`, kept as the oracle); only the Cholesky solve and
    the P update remain dense. Validated against the oracle in
    tests/test_solver.py::test_structured_riccati_matches_generic.
    """
    nu = R.shape[-1]
    eyeu = jnp.eye(nu, dtype=Q.dtype)
    half_h2 = 0.5 * h * h

    def step(carry, inp):
        P, pvec = carry
        Qk, Rk, Mk, qk, rk, dk = inp
        Pq, Pv = P[:, :18], P[:, 18:]
        PA = jnp.concatenate([Pq, h * Pq + Pv], axis=1)            # (36, 36)
        AtPA = jnp.concatenate([PA[:18], h * PA[:18] + PA[18:]], axis=0)
        PB_a = half_h2 * Pq + h * Pv                               # (36, 18)
        BtPA_a = half_h2 * PA[:18] + h * PA[18:]                   # (18, 36)
        BtPB_aa = half_h2 * PB_a[:18] + h * PB_a[18:]              # (18, 18)
        Qxx = Qk + AtPA
        Quu = (Rk + lm_reg * eyeu).at[:18, :18].add(BtPB_aa)
        Qux = Mk.T.at[:18, :].add(BtPA_a)
        Pd = P @ dk + pvec
        qx = qk + jnp.concatenate([Pd[:18], h * Pd[:18] + Pd[18:]])
        qu = rk.at[:18].add(half_h2 * Pd[:18] + h * Pd[18:])
        L = jnp.linalg.cholesky(Quu)
        rhs = jnp.concatenate([Qux, qu[:, None]], axis=1)
        sol = jax.scipy.linalg.cho_solve((L, True), rhs)
        K, kff = -sol[:, :-1], -sol[:, -1]
        P_new = Qxx + Qux.T @ K
        P_new = 0.5 * (P_new + P_new.T)
        p_new = qx + Qux.T @ kff
        return (P_new, p_new), (K, kff)

    (_, _), (K, kff) = jax.lax.scan(
        step, (P_N, p_N), (Q, R, M, qx_vec, ru_vec, defects), reverse=True
    )
    return K, kff


def _forward_delta_structured(h, K, kff, defects, dx0, alpha):
    """Affine rollout specialized to the double-integrator dynamics."""
    half_h2 = 0.5 * h * h

    def step(dx, inp):
        Kk, kk, dk = inp
        du = alpha * kk + Kk @ dx
        du_a = du[:18]
        dx_next = jnp.concatenate(
            [dx[:18] + h * dx[18:] + half_h2 * du_a, dx[18:] + h * du_a]
        ) + alpha * dk
        return dx_next, (dx, du)

    dxN, (dX, dU) = jax.lax.scan(step, alpha * dx0, (K, kff, defects))
    dX = jnp.concatenate([dX, dxN[None]], axis=0)
    return dX, dU


def _forward_delta(A, B, K, kff, defects, dx0, alpha):
    """Affine rollout of the LQR policy with step scaling alpha.
    A/B may be constant (2-d) or per-node (3-d)."""
    N = K.shape[0]
    if A.ndim == 2:
        A = jnp.broadcast_to(A[None], (N,) + A.shape)
    if B.ndim == 2:
        B = jnp.broadcast_to(B[None], (N,) + B.shape)

    def step(dx, inp):
        Ak, Bk, Kk, kk, dk = inp
        du = alpha * kk + Kk @ dx
        dx_next = Ak @ dx + Bk @ du + alpha * dk
        return dx_next, (dx, du)

    dxN, (dX, dU) = jax.lax.scan(step, alpha * dx0, (A, B, K, kff, defects))
    dX = jnp.concatenate([dX, dxN[None]], axis=0)
    return dX, dU


class TrajOptSolver:
    """Stateless functional solver bound to (robot, configs).

    `solve` is pure and jit/vmap/shard_map-friendly: all contact parameters
    come in through OCPParams.
    """

    def __init__(
        self,
        spec: RobotSpec,
        opt: MPCOptConfig,
        cost: MPCCostConfig,
        dtype=jnp.float32,
    ):
        self.spec = spec
        self.opt = opt
        self.cost = cost
        self.dtype = dtype
        self.N = opt.n_nodes
        # per-node dt optimization appends a 31st input (reference
        # enable_time_opt, config_abstract.py:49-52); the shooting dynamics
        # then carry bilinear dt*a terms and A/B are linearized per node.
        self.time_opt = bool(opt.enable_time_opt)
        self.nu = NU + (1 if self.time_opt else 0)
        self.dt_nodes = opt.get_dt_nodes()
        self.weights = make_weights(opt, cost, spec, dtype=dtype)
        self.A, self.B = dynamics_matrices(self.dt_nodes, dtype)
        import numpy as _np

        self.ls_alphas = _np.asarray(opt.ls_alphas, _np.dtype(jnp.dtype(dtype).name))
        from .linearize import make_const_blocks

        self._jac_const = make_const_blocks(self.weights)
        check_solver_modes(opt)
        # Riccati sweep: on a GPU, batched solves run the fused Triton sweep
        # + rollout kernel (ops/riccati_triton.py, behind a custom_vmap);
        # unbatched solves and every other backend run the XLA scan.
        self._riccati_mode = opt.riccati_mode
        if self._riccati_mode == "auto":
            self._riccati_mode = (
                "triton" if jax.default_backend() == "gpu" else "sequential"
            )
        # Inequality-violation normalization for the qp_tol exit test: cone
        # rows scale with the per-foot gravity share (m*g/4 — the nominal
        # stance load), torque rows with the actuator limit, patch rows with
        # a 10 cm length scale. qp_tol=1e-2 then means cone <= 1% of the
        # foot load (~0.4 N on Go2), torque <= 1% of the limit, patch <= 1 mm.
        total_w = max(float(_np.asarray(self.weights.total_weight)), 1.0)
        tlim = _np.asarray(spec.torque_limit, _np.float64)
        self._ineq_scales = _np.concatenate(
            [_np.full(NC_CONE, 0.25 * total_w), tlim, _np.full(NC_PATCH, 0.1)]
        ).astype(_np.dtype(jnp.dtype(dtype).name))
        # AL shift caps (clipped dual update — the inequality counterpart of
        # update_multipliers' lam_max): generous safety bounds well above the
        # annealed fixed points seen in practice.
        self._lam_ineq_max = _np.concatenate(
            [_np.full(NC_CONE, 0.5 * total_w), tlim, _np.full(NC_PATCH, 0.2)]
        ).astype(_np.dtype(jnp.dtype(dtype).name))

    # ---------------- cost/merit ----------------
    def _total_cost(self, X, U, p: OCPParams):
        N = U.shape[0]
        Z = jnp.concatenate([X[:-1], U], axis=1)

        def res_one(z, cnt, peak, plane, cnt_loc, patch, lam, lami):
            return _stage_residual_z(
                self.spec, self.weights, z, cnt, peak, plane, cnt_loc, patch,
                p.restrict, p.base_ref, p.joint_ref, p.step_height, lam, lami,
            )

        cnt_n = p.cnt[:, :N].T
        peak_n = p.peak[:, :N].T
        plane_n = p.plane_point[:, :N].transpose(1, 0, 2)
        loc_n = p.cnt_loc[:, :N].transpose(1, 0, 2)
        patch_n = p.patch_radius[:, :N].T
        rs = jax.vmap(res_one)(Z, cnt_n, peak_n, plane_n, loc_n, patch_n,
                               p.lam_eq, p.lam_ineq)
        r_term = terminal_residual(
            self.spec, self.weights, X[-1], p.peak[:, -1], p.base_ref_e,
            p.joint_ref, p.step_height,
        )
        return 0.5 * jnp.sum(rs * rs) + 0.5 * jnp.sum(r_term * r_term)

    def _defects(self, X, U, p: OCPParams):
        X_next = jax.vmap(dynamics_step, in_axes=(0, 0, 0))(X[:-1], U, p.dt)
        return X_next - X[1:]

    # ---------------- one SQP iteration ----------------
    def _gn_blocks(self, X, U, p: OCPParams, use_fast_linearize=False):
        """Linearize + Gram: the GN blocks of one problem,
        (Q, R, M, qx, ru, P_N, p_N, defects, dx0), batch-free."""
        w = self.weights
        if use_fast_linearize and not self.time_opt:
            # structure-exploiting assembly: 6-18 RNEA pullbacks + 24 FK
            # pullbacks per node instead of 66 jacfwd tangents through the
            # full residual stack (solver/linearize.py); off by default
            from .linearize import linearize_stages_fast

            r, Jx, Ju = linearize_stages_fast(
                self.spec, w, X, U, p, *self._jac_const,
                include_torque=self.opt.torque_limit_in_qp,
            )
        else:
            r, Jx, Ju = _linearize_stages(
                self.spec, w, X, U, p, include_torque=self.opt.torque_limit_in_qp
            )
        rT, JT = _linearize_terminal(self.spec, w, X[-1], p)

        # ONE merged Gram contraction on J=[Jx|Ju|r]: Q, R, M, qx, ru are
        # slices of J^T J. The barrier materializes (r, Jx, Ju) first so XLA
        # cannot fuse (and re-run) the Jacobian assembly into the einsum
        # producers.
        r, Jx, Ju = jax.lax.optimization_barrier((r, Jx, Ju))
        nu = Ju.shape[-1]
        J = jnp.concatenate([Jx, Ju, r[..., None]], axis=-1)
        G = jnp.einsum("nri,nrj->nij", J, J)
        Q = G[:, :NX, :NX]
        R = G[:, NX:NX + nu, NX:NX + nu]
        M = G[:, :NX, NX:NX + nu]
        qx_vec = G[:, :NX, NX + nu]
        ru_vec = G[:, NX:NX + nu, NX + nu]
        P_N = JT.T @ JT + self.cost.reg_eps_e * jnp.eye(NX, dtype=X.dtype)
        p_N = JT.T @ rT

        defects = self._defects(X, U, p)
        dx0 = p.x0 - X[0]
        return Q, R, M, qx_vec, ru_vec, P_N, p_N, defects, dx0

    def _sqp_iter(self, X, U, p: OCPParams, merit_rho, alphas=None,
                  use_fast_linearize=True, return_step=False):
        """One GN/RTI iteration. With return_step (the non-time_opt solve
        loop), returns the RAW alpha=1 step (dX1, dU1, defects) and leaves
        candidate selection to solve()'s shared cost+dual epilogue;
        otherwise runs the legacy merit select and returns the accepted
        iterate (time_opt path, direct callers)."""
        Q, R, M, qx_vec, ru_vec, P_N, p_N, defects, dx0 = self._gn_blocks(
            X, U, p, use_fast_linearize)

        if self._riccati_mode == "triton" and not self.time_opt:
            # whole sweep + alpha=1 rollout in one kernel launch for batched
            # solves; unbatched solves keep the structured scans
            dX1, dU1 = self._get_riccati_rollout()(
                Q, R, M, qx_vec, ru_vec, P_N, p_N, defects, dx0)
            if return_step:
                return dX1, dU1, defects
            return self._merit_select(X, U, p, dX1, dU1, defects,
                                      merit_rho, alphas)

        if self.time_opt:
            # dt*a bilinear terms: linearize the shooting dynamics per node
            Z = jnp.concatenate([X[:-1], U], axis=1)

            def dyn_z(z, dt_nom):
                return dynamics_step(z[:NX], z[NX:], dt_nom)

            J_dyn = jax.vmap(jax.jacfwd(dyn_z))(Z, p.dt)
            A_dyn, B_dyn = J_dyn[:, :, :NX], J_dyn[:, :, NX:]
        else:
            A_dyn, B_dyn = jnp.asarray(self.A), jnp.asarray(self.B)

        lm = jnp.asarray(self.opt.lm_reg, X.dtype)
        structured = not self.time_opt and self._riccati_mode == "sequential"
        if self._riccati_mode == "associative":
            from .parallel_riccati import parallel_riccati

            K, kff = parallel_riccati(
                A_dyn, B_dyn, Q, R, M, qx_vec, ru_vec, P_N, p_N, defects, lm
            )
        elif structured:
            K, kff = _riccati_solve_structured(
                self.dt_nodes, Q, R, M, qx_vec, ru_vec, P_N, p_N, defects, lm
            )
        else:
            K, kff = _riccati_solve(
                A_dyn, B_dyn, Q, R, M, qx_vec, ru_vec, P_N, p_N, defects, lm
            )

        return self._line_search(X, U, p, K, kff, defects, dx0, merit_rho,
                                 alphas, structured, A_dyn, B_dyn,
                                 return_step=return_step)

    def _line_search(self, X, U, p, K, kff, defects, dx0, merit_rho, alphas,
                     structured, A_dyn=None, B_dyn=None, return_step=False):
        # The affine rollout is homogeneous in alpha (dx0, kff, and the
        # defect drive all carry the step scale), so ONE rollout at alpha=1
        # gives every candidate: dX(alpha) = alpha * dX(1). The per-alpha
        # work is reduced to an elementwise scale + the merit evaluation.
        one = jnp.asarray(1.0, X.dtype)
        if structured:
            dX1, dU1 = _forward_delta_structured(
                self.dt_nodes, K, kff, defects, dx0, one)
        else:
            dX1, dU1 = _forward_delta(A_dyn, B_dyn, K, kff, defects, dx0, one)
        if return_step:
            return dX1, dU1, defects
        return self._merit_select(X, U, p, dX1, dU1, defects, merit_rho,
                                  alphas)

    def _merit_select(self, X, U, p, dX1, dU1, defects, merit_rho, alphas):
        def candidate(alpha):
            Xc, Uc = X + alpha * dX1, U + alpha * dU1
            cost_c = self._total_cost(Xc, Uc, p)
            if self.time_opt:
                # bilinear dynamics: evaluate the true post-step defects
                defects_c = self._defects(Xc, Uc, p)
                merit = cost_c + merit_rho * jnp.sum(jnp.abs(defects_c))
            else:
                # linear dynamics => defects shrink exactly by (1-alpha)
                merit = cost_c + merit_rho * (1.0 - alpha) * jnp.sum(jnp.abs(defects))
            return merit

        alphas = jnp.asarray(self.ls_alphas if alphas is None else alphas)
        merits = jax.vmap(candidate)(alphas)
        # Deterministic tie-break: backends (GPU vs CPU) produce ulp-level
        # merit differences, and a bare argmin then selects DIFFERENT alphas
        # at near-ties, which compounds across SQP iterations into visible
        # (~5e-3) cross-backend trajectory divergence. Treat
        # candidates within a relative epsilon of the minimum as tied and
        # prefer the LARGEST alpha among them — both backends then choose
        # identically wherever their merits agree to ~30 ulps.
        m_min = jnp.min(merits)
        tol = jnp.asarray(4e-6, merits.dtype) * jnp.abs(m_min)
        best = jnp.argmax(jnp.where(merits <= m_min + tol, alphas, -jnp.inf))
        a_best = alphas[best].astype(X.dtype)
        X_new = X + a_best * dX1
        U_new = U + a_best * dU1
        step_norm = a_best * jnp.max(jnp.abs(dU1))
        return X_new, U_new, merits[best], step_norm, alphas[best]

    def _get_riccati_rollout(self):
        """custom_vmap dispatcher for the fused Riccati sweep + alpha=1
        rollout: a vmapped (batched) solve runs ONE Triton kernel launch
        over the whole batch (ops/riccati_triton.py), an unbatched solve
        keeps the structured XLA scans. Returns (dX1, dU1). Off the GPU
        (riccati_mode="triton" forced on the CPU, as the tests do) the
        kernel runs in Pallas interpret mode."""
        if hasattr(self, "_riccati_rollout"):
            return self._riccati_rollout
        from ..ops.riccati_triton import riccati_rollout_batched

        h, lm = self.dt_nodes, float(self.opt.lm_reg)
        interpret = jax.default_backend() != "gpu"

        @jax.custom_batching.custom_vmap
        def riccati_rollout(Q, R, M, qx, ru, P_N, p_N, defects, dx0):
            K, kff = _riccati_solve_structured(
                h, Q, R, M, qx, ru, P_N, p_N, defects,
                jnp.asarray(lm, Q.dtype))
            return _forward_delta_structured(
                h, K, kff, defects, dx0, jnp.asarray(1.0, Q.dtype))

        @riccati_rollout.def_vmap
        def _rule(axis_size, in_batched, *args):
            args = [x if b else jnp.broadcast_to(x[None], (axis_size,) + x.shape)
                    for x, b in zip(args, in_batched)]
            dX1, dU1 = riccati_rollout_batched(h, lm, *args,
                                               interpret=interpret)
            return (dX1, dU1), (True, True)

        self._riccati_rollout = riccati_rollout
        return riccati_rollout

    # ---------------- public API ----------------
    def solve(
        self,
        X: jax.Array,
        U: jax.Array,
        params: OCPParams,
        n_iter: int,
        merit_rho: float = 1.0e2,
        use_fast_linearize: bool = False,
    ) -> Solution:
        """Run up to n_iter (static bound) SQP iterations from warm start.

        Each SQP iteration wraps an inner QP loop of up to `max_qp_iter`
        augmented-Lagrangian passes over the inequality hinges (friction
        cone, torque limits, contact patch): GN step with the current hinge
        shifts -> dual update s <- clip(s + g, 0, s_max) -> re-step, exiting
        early once the scale-normalized violation drops below `qp_tol`.
        This is the bounded-violation role of HPIPM's interior-point
        iterations under the reference's budget semantics
        (`mpc_opt.py:27` max_qp_iter=6, `config_abstract.py:71-74` qp_tol);
        unlike HPIPM the inner passes re-linearize (fresh GN), which is
        strictly tighter. In the warm-started RTI regime the annealed duals
        carried across replans (Solution.lam_ineq -> OCPParams.lam_ineq)
        keep violations below qp_tol, so the inner loop exits after one
        pass and steady-state cost matches the plain RTI iteration.

        Multi-iteration solves stop early once the step norm drops below
        nlp_tol (the reference's outer-loop tolerance, config_abstract.py:71);
        warm-started RTI solves (n_iter == 1) use the reduced steady-state
        line-search set.
        """
        alphas = (
            self.opt.ls_alphas_steady if n_iter <= 1 else self.opt.ls_alphas
        )
        # shared epilogue (non-time_opt): ONE FK/RNEA launch evaluates the
        # merit cost of every line-search candidate AND the AL dual-update
        # inputs, replacing the per-candidate cost pass + separate dual pass
        shared = not self.time_opt
        nlp_tol = jnp.asarray(self.opt.nlp_tol, X.dtype)
        qp_tol = jnp.asarray(self.opt.qp_tol, X.dtype)
        max_qp = max(1, int(self.opt.max_qp_iter))
        zero = jnp.asarray(0.0, X.dtype)

        r_eq0 = jnp.zeros((self.N, 18), X.dtype)

        def qp_cond(carry):
            j, _, _, _, _, _, viol, _, _ = carry
            return jnp.logical_and(j < max_qp,
                                   jnp.logical_or(j == 0, viol > qp_tol))

        def qp_body(carry):
            j, X, U, lam, _, _, _, _, _ = carry
            p_j = dataclasses.replace(params, lam_ineq=lam)
            if shared:
                dX1, dU1, defects_pre = self._sqp_iter(
                    X, U, p_j, merit_rho, alphas=alphas,
                    use_fast_linearize=use_fast_linearize, return_step=True,
                )
                a = jnp.asarray(alphas, X.dtype)
                Xc = X[None] + a[:, None, None] * dX1[None]
                Uc = U[None] + a[:, None, None] * dU1[None]
                cost_c, r_eq_c, g_c = jax.vmap(
                    lambda Xa, Ua: self._cost_dual(Xa, Ua, params))(Xc, Uc)
                # linear dynamics => defects shrink exactly by (1 - alpha)
                merits = (cost_c + merit_rho * (1.0 - a)
                          * jnp.sum(jnp.abs(defects_pre)))
                # same deterministic near-tie resolution as _merit_select
                # (prefer the largest tied alpha)
                m_min = jnp.min(merits)
                tol_tie = jnp.asarray(4e-6, merits.dtype) * jnp.abs(m_min)
                best = jnp.argmax(
                    jnp.where(merits <= m_min + tol_tie, a, -jnp.inf))
                X, U = Xc[best], Uc[best]
                cost = merits[best]
                r_eq, g = r_eq_c[best], g_c[best]
                alpha = a[best]
                step_norm = alpha * jnp.max(jnp.abs(dU1))
            else:
                X, U, cost, step_norm, alpha = self._sqp_iter(
                    X, U, p_j, merit_rho, alphas=alphas,
                    use_fast_linearize=use_fast_linearize,
                )
                # ONE shared evaluation yields both dual-update inputs: the
                # equality rows ride along for the caller (Solution.r_eq)
                r_eq, g = self._dual_g(X, U, params)
            lam, viol = self._ineq_update_from_g(g, params, lam)
            return (j + 1, X, U, lam, r_eq, cost, viol, step_norm, alpha)

        def cond(carry):
            i, _, _, _, _, _, _, step_norm, _, _ = carry
            return jnp.logical_and(i < n_iter,
                                   jnp.logical_or(i == 0, step_norm > nlp_tol))

        def body(carry):
            i, X, U, lam, r_eq, _, _, _, _, _ = carry
            (j, X, U, lam, r_eq, cost, viol, step_norm,
             alpha) = jax.lax.while_loop(
                qp_cond, qp_body,
                (jnp.asarray(0), X, U, lam, r_eq, zero, zero, zero, zero)
            )
            return (i + 1, X, U, lam, r_eq, cost, viol, step_norm, alpha, j)

        (n_sqp, X, U, lam_ineq, r_eq, cost, viol, step_norm, alpha,
         qp_iters) = jax.lax.while_loop(
            cond, body,
            (jnp.asarray(0), X, U, params.lam_ineq, r_eq0, zero, zero, zero,
             zero, jnp.asarray(0)),
        )
        defect = jnp.max(jnp.abs(self._defects(X, U, params)))
        return Solution(
            X, U,
            SolveStats(cost, defect, step_norm, alpha, viol, qp_iters,
                       n_sqp),
            lam_ineq, r_eq,
        )

    # ---------------- inequality (AL) dual updates ----------------
    def _ineq_g(self, X, U, p: OCPParams):
        """Raw inequality constraint values (N, NC_INEQ), physical units."""
        return self._dual_g(X, U, p)[1]

    def _dual_g(self, X, U, p: OCPParams):
        """(r_eq (N, 18), g_ineq (N, NC_INEQ)) — both AL dual-update inputs
        from one shared FK/RNEA evaluation."""
        from ..models import dynamics as dyn
        from ..ocp.problem import equality_residuals, split_input

        N = U.shape[0]
        cnt_n = p.cnt[:, :N].T
        plane_n = p.plane_point[:, :N].transpose(1, 0, 2)
        loc_n = p.cnt_loc[:, :N].transpose(1, 0, 2)
        patch_n = p.patch_radius[:, :N].T

        def one(x, u, cnt, plane, loc, patch):
            q, v = split_state(x)
            a, f = split_input(u)
            fe = cnt[:, None] * f
            tau = dyn.rnea(self.spec, q, v, a, f_ext_feet=fe)
            pf = dyn.foot_positions(self.spec, q)
            vf = dyn.foot_velocities(self.spec, q, v)
            r_eq = equality_residuals(self.spec, self.weights, x, u, cnt,
                                      plane, core=(pf, vf, tau))
            g = ineq_values(self.spec, self.weights, x, u, cnt, loc, patch,
                            p.restrict, core=(pf, tau))
            return r_eq, g

        return jax.vmap(one)(X[:-1], U, cnt_n, plane_n, loc_n, patch_n)

    def _cost_dual(self, X, U, p: OCPParams):
        """(cost, r_eq, g) at one iterate."""
        r_eq, g = self._dual_g(X, U, p)
        return self._total_cost(X, U, p), r_eq, g

    def _ineq_update_from_g(self, g, params: OCPParams, lam_ineq):
        """Clipped AL dual update + scale-normalized violation, given the
        raw constraint values g (see update_ineq_multipliers)."""
        N = g.shape[0]
        cnt_n = params.cnt[:, :N].T                     # (N, 4)
        mask = jnp.concatenate(
            [
                jnp.repeat(cnt_n, 5, axis=1),
                jnp.ones((N, NC_TORQUE), g.dtype),
                jnp.broadcast_to(params.restrict, (N, NC_PATCH)) * cnt_n,
            ],
            axis=1,
        )
        step = jnp.maximum(g, 0.0) + 0.25 * jnp.minimum(g, 0.0)
        lam_new = mask * jnp.clip(
            lam_ineq + step, 0.0, jnp.asarray(self._lam_ineq_max))
        viol = jnp.max(jnp.maximum(g, 0.0) / jnp.asarray(self._ineq_scales))
        return lam_new, viol

    def update_ineq_multipliers(self, X, U, params: OCPParams, lam_ineq):
        """Clipped AL dual update on the hinge shifts + the scale-normalized
        violation used for the qp_tol exit.

        s <- mask * clip(s + g_+ + 0.25*g_-, 0, s_max): violations grow the
        shift at the full AL rate; strict feasibility decays it DAMPED
        (factor 0.25) — the single inexact-GN inner step overshoots the
        active-set boundary, and an undamped decay limit-cycles between
        "shift high -> strictly feasible -> shift collapses -> violate"
        (measured on the mu=0.25 trot: 2 inner passes forever; damped decay
        settles to 1 pass with zero violation). Cone rows reset when the
        foot leaves contact (vacuous constraint), patch rows when
        unrestricted — mirroring how the reference's dual warm start only
        carries duals for constraints present in the shifted problem
        (solver.py:290-342)."""
        g = self._ineq_g(X, U, params)                  # (N, NC_INEQ)
        return self._ineq_update_from_g(g, params, lam_ineq)

    # ---------------- reference API parity (solver.py:set_* setters) -------
    # NOTE: these mutate the config consulted at TRACE time; they affect
    # jit specializations created after the call (the controller's
    # first-solve boost uses the n_iter static argument instead).
    def set_max_iter(self, n: int) -> None:
        self.opt.max_iter = int(n)

    def set_nlp_tol(self, tol: float) -> None:
        self.opt.nlp_tol = float(tol)

    def set_qp_tol(self, tol: float) -> None:
        self.opt.qp_tol = float(tol)

    # ---------------- warm starts ----------------
    def cold_start(self, params: OCPParams) -> Tuple[jax.Array, jax.Array]:
        """Stationary initial guess: hold x0, gravity-balancing forces."""
        X = jnp.tile(params.x0[None], (self.N + 1, 1))
        a0 = jnp.zeros(18, dtype=self.dtype)
        m_tot = self.spec.mass.sum()
        n_active = jnp.maximum(params.cnt[:, :-1].sum(0), 1.0)  # (N,)
        fz = dyn.GRAVITY * m_tot / n_active
        f = jnp.zeros((self.N, 4, 3), dtype=self.dtype)
        f = f.at[:, :, 2].set(params.cnt[:, :-1].T * fz[:, None])
        cols = [jnp.tile(a0[None], (self.N, 1)), f.reshape(self.N, 12)]
        if self.time_opt:
            cols.append(jnp.full((self.N, 1), self.dt_nodes, self.dtype))
        U = jnp.concatenate(cols, axis=1)
        return X, U

    def shift_warmstart(self, X, U, shift):
        """Shift the previous solution by `shift` nodes, repeating the tail
        (reference warm_start_solver, solver.py:290-342). `shift` may be traced."""
        idx_x = jnp.clip(jnp.arange(self.N + 1) + shift, 0, self.N)
        idx_u = jnp.clip(jnp.arange(self.N) + shift, 0, self.N - 1)
        return X[idx_x], U[idx_u]

    def shift_multipliers(self, lam_eq, shift):
        idx = jnp.clip(jnp.arange(self.N) + shift, 0, self.N - 1)
        return lam_eq[idx]

    def update_multipliers(self, X, U, params: OCPParams,
                           lam_max: float = 30.0, r_eq=None) -> jax.Array:
        """Augmented-Lagrangian dual update: lam <- clip(lam + r_eq(X, U)).

        The multipliers live in the weighted residual space; with the RTI
        regime (1 SQP iteration per replan) they anneal the equality
        violations across successive solves — the functional counterpart of
        HPIPM's warm-started duals. Pass `r_eq=sol.r_eq` to reuse the rows
        the solve's inner dual evaluation already computed (zero extra
        FK/RNEA work)."""
        if r_eq is None:
            r_eq = self._dual_g(X, U, params)[0]
        return jnp.clip(params.lam_eq + r_eq, -lam_max, lam_max)


def make_params(
    solver: TrajOptSolver,
    x0,
    cnt,
    peak=None,
    plane_point=None,
    cnt_loc=None,
    patch_radius=None,
    restrict=0.0,
    base_ref=None,
    base_ref_e=None,
    joint_ref=None,
    step_height=0.05,
    dt=None,
    ground_height=0.0,
    lam_eq=None,
    lam_ineq=None,
) -> OCPParams:
    """Ergonomic OCPParams builder with sensible defaults.

    Host-side assembly in NUMPY on purpose: eager jnp ops would each
    dispatch (and compile) a tiny device program; numpy leaves cross into
    jit as one transfer each.
    """
    import numpy as np

    N = solver.N
    np_dtype = np.dtype(jnp.dtype(solver.dtype).name)
    asnp = lambda x: np.asarray(x, dtype=np_dtype)
    x0 = asnp(x0)
    cnt = asnp(cnt)
    if peak is None:
        peak = 1.0 - cnt
    if plane_point is None:
        plane_point = np.zeros((4, N + 1, 3), np_dtype)
        plane_point[:, :, 2] = ground_height
    if cnt_loc is None:
        cnt_loc = np.zeros((4, N + 1, 3), np_dtype)
    if patch_radius is None:
        # default: unbounded patch (hinge inactive) — restriction then acts
        # through the quadratic displacement pull only
        patch_radius = np.full((4, N + 1), 1.0e3, np_dtype)
    if base_ref is None:
        base_ref = np.zeros(12, np_dtype)
    if base_ref_e is None:
        base_ref_e = base_ref
    if joint_ref is None:
        joint_ref = np.asarray(solver.spec.q_home)[6:]
    if dt is None:
        dt = np.full((N,), solver.dt_nodes, np_dtype)
    if lam_eq is None:
        lam_eq = np.zeros((N, 18), np_dtype)
    if lam_ineq is None:
        lam_ineq = np.zeros((N, NC_INEQ), np_dtype)
    return OCPParams(
        x0=x0,
        cnt=cnt,
        peak=asnp(peak),
        plane_point=asnp(plane_point),
        cnt_loc=asnp(cnt_loc),
        patch_radius=asnp(patch_radius),
        restrict=asnp(restrict),
        base_ref=asnp(base_ref),
        base_ref_e=asnp(base_ref_e),
        joint_ref=asnp(joint_ref),
        step_height=asnp(step_height),
        dt=asnp(dt),
        lam_eq=asnp(lam_eq),
        lam_ineq=asnp(lam_ineq),
    )
