"""Structure-exploiting stage linearization (the QP-side hot path).

`_linearize_stages` (solver/sqp.py) differentiates the full 130-row residual
stack with jacfwd: 66 forward tangents per node, every one of them dragged
through the RNEA graph — even though most rows are linear with constant
Jacobians. This module assembles the same (r, Jx, Ju) from structure:

- tracking rows (base/joint/acc)            -> constant diagonal blocks,
- force-reg / swing-force / cone rows       -> closed-form diagonals in f
  (contact masks and hinge activity enter as multipliers, never branches),
- foot kinematic rows (swing peak, disp,
  patch hinge, contact pin, clearance)      -> products with the foot
  position/velocity Jacobians,
- dynamics-consistency + torque-hinge rows  -> ONE jacrev pullback sweep of
  the RNEA outputs wrt (x, a, f) (6 rows, or 18 with torque rows in the QP).

AD cost per node drops from 66 forward tangents through everything to
6-18 reverse pullbacks through RNEA + 24 through FK. Validated row-for-row
against the jacfwd oracle in tests/test_fast_linearize.py.

Reference counterpart: the CasADi-codegen'd constraint Jacobians inside
acados (`mpc_controller/utils/solver.py:344-353` pushes parameters into
generated C; here the "codegen" is this hand-structured assembly).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..models import dynamics as dyn
from ..ocp.problem import (
    NU,
    NX,
    OCPParams,
    Weights,
    cone_values,
    hinge_shifted,
    hinge_shifted_act,
    split_input,
    split_state,
)

N_FOOT = 4


def make_const_blocks(w: Weights) -> Tuple[np.ndarray, np.ndarray]:
    """Constant Jacobian rows for [rb(12); rj(24); ra(12)] (numpy, built on
    host once per solver — the tracking residuals are linear in z)."""
    base = np.asarray(w.base)
    joint = np.asarray(w.joint)
    acc = np.asarray(w.acc)
    dtype = base.dtype
    Jx = np.zeros((48, NX), dtype)
    Ju = np.zeros((48, NU), dtype)
    # rb: [q[:6]; v[:6]] * w.base
    for i in range(6):
        Jx[i, i] = base[i]
        Jx[6 + i, 18 + i] = base[6 + i]
    # rj: [q[6:18]; v[6:18]] * w.joint
    for i in range(12):
        Jx[12 + i, 6 + i] = joint[i]
        Jx[24 + i, 24 + i] = joint[12 + i]
    # ra: a[6:18] * w.acc
    for i in range(12):
        Ju[36 + i, 6 + i] = acc[i]
    return Jx, Ju


# hinge gradient pattern of the pyramid cone rows wrt (fx, fy, fz), before
# the mu factor: rows = [-fz; fx-mu fz; -fx-mu fz; fy-mu fz; -fy-mu fz]
_CONE_XY = np.asarray(
    [[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]]
)
_CONE_Z = np.asarray([-1.0, -1.0, -1.0, -1.0, -1.0])
_CONE_MU_MASK = np.asarray([0.0, 1.0, 1.0, 1.0, 1.0])  # rows using mu*fz


def linearize_stage_fast(spec, w: Weights, x, u, cnt_k, peak_k, plane_k,
                         cnt_loc_k, patch_k, restrict, step_height,
                         Jx_const, Ju_const, lam_ineq_k=None,
                         include_torque: bool = True):
    """(Jx, Ju) for one node, rows ordered exactly as
    ocp.problem.stage_residual (no dt slot)."""
    q, v = split_state(x)
    a, f = split_input(u)
    f_eff = cnt_k[:, None] * f

    # --- AD of the nonlinear core: 6/18 pullbacks (RNEA) + 24 (FK) ---
    n_tau = 18 if include_torque else 6

    def tau_rows(x_, a_, fe_):
        q_, v_ = split_state(x_)
        return dyn.rnea(spec, q_, v_, a_, f_ext_feet=fe_)[:n_tau]

    Jt_x, Jt_a, Jt_f = jax.jacrev(tau_rows, argnums=(0, 1, 2))(x, a, f_eff)
    tau = tau_rows(x, a, f_eff)
    Jt_f = Jt_f.reshape(n_tau, 12)

    def pv(x_):
        q_, v_ = split_state(x_)
        return dyn.foot_positions(spec, q_), dyn.foot_velocities(spec, q_, v_)

    Jp, Jvf = jax.jacrev(pv)(x)          # (4, 3, NX) each
    p_feet = dyn.foot_positions(spec, q)
    return assemble_stage_jacobian(
        spec, w, x, u, cnt_k, peak_k, plane_k, cnt_loc_k, patch_k, restrict,
        p_feet, tau, Jp, Jvf, Jt_x, Jt_a, Jt_f, Jx_const, Ju_const,
        include_torque, lam_ineq_k=lam_ineq_k,
    )


def assemble_stage_jacobian(spec, w: Weights, x, u, cnt_k, peak_k, plane_k,
                            cnt_loc_k, patch_k, restrict,
                            p_feet, tau, Jp, Jvf, Jt_x, Jt_a, Jt_f,
                            Jx_const, Ju_const, include_torque: bool,
                            lam_ineq_k=None):
    """Assemble (Jx, Ju) from the dynamics core and its Jacobians.

    Jp/Jvf: (4, 3, NX); Jt_x: (n_tau, NX); Jt_a: (n_tau, 18);
    Jt_f: (n_tau, 12) wrt f_eff (scaled by cnt below). lam_ineq_k shifts
    the hinge activity tests (AL duals — see ocp.problem.stage_residual)."""
    dtype = x.dtype
    f_eff = cnt_k[:, None] * split_input(u)[1]
    cnt12 = jnp.repeat(cnt_k, 3)
    if lam_ineq_k is None:
        s_cone = s_tau = s_patch = 0.0
    else:
        s_cone = cnt_k[:, None] * lam_ineq_k[:20].reshape(4, 5)
        s_tau = lam_ineq_k[20:32]
        s_patch = lam_ineq_k[32:36]

    # rf: diag(cnt ⊗ w.f_reg) on the f columns; rf_zero: diag((1-cnt) ⊗ 1)
    f_diag = (cnt_k[:, None] * jnp.asarray(w.f_reg)).reshape(-1)
    rf_Ju = jnp.zeros((12, NU), dtype).at[jnp.arange(12), 18 + jnp.arange(12)].set(f_diag)
    fz_diag = jnp.repeat(1.0 - cnt_k, 3)
    rfz_Ju = jnp.zeros((12, NU), dtype).at[jnp.arange(12), 18 + jnp.arange(12)].set(fz_diag)

    # r_swing: peak_i * w.swing_i * dp_z/dx
    swing_Jx = (peak_k * jnp.asarray(w.swing))[:, None] * Jp[:, 2, :]

    # r_disp: restrict * cnt_i * w.foot_disp * dp_xy/dx
    disp_Jx = (restrict * cnt_k * w.foot_disp)[:, None, None] * Jp[:, :2, :]
    disp_Jx = disp_Jx.reshape(8, NX)

    # r_patch hinge: restrict * cnt * w.patch * (dist > r) * unit_d . dp_xy/dx
    d_xy = p_feet[:, :2] - cnt_loc_k[:, :2]
    dist = jnp.sqrt(jnp.sum(d_xy * d_xy, axis=1) + 1.0e-12)
    unit = d_xy / dist[:, None]
    patch_act = hinge_shifted_act(dist - patch_k, s_patch)
    patch_Jx = (restrict * cnt_k * w.patch * patch_act)[:, None] * jnp.einsum(
        "ij,ijx->ix", unit, Jp[:, :2, :]
    )

    # r_dyn: the 6 RNEA base rows; f enters through f_eff = cnt * f
    dyn_Jx = w.dyn_cons * Jt_x[:6]
    dyn_Ju = w.dyn_cons * jnp.concatenate(
        [Jt_a[:6], Jt_f[:6] * cnt12[None, :]], axis=1
    )

    # r_cnt: cnt_i * w.contact_vel * (dvf/dx + [z row] stab_gain_i * dp_z/dx)
    stab = jnp.asarray(w.stab_gain)
    cnt_Jx = Jvf.at[:, 2, :].add(stab[:, None] * Jp[:, 2, :])
    cnt_Jx = (cnt_k * w.contact_vel)[:, None, None] * cnt_Jx
    cnt_Jx = cnt_Jx.reshape(12, NX)

    # cone hinges (f columns only): per-foot 5x3 gradients, block-diagonal
    acts = hinge_shifted_act(cone_values(f_eff, w.mu), s_cone)      # (4, 5)
    g_xy = jnp.asarray(_CONE_XY, dtype)                  # (5, 2)
    g_z = jnp.asarray(_CONE_Z, dtype) * (
        jnp.asarray(_CONE_MU_MASK, dtype) * w.mu
        + (1.0 - jnp.asarray(_CONE_MU_MASK, dtype))
    )                                                    # (5,)
    grad = jnp.concatenate([jnp.tile(g_xy[None], (N_FOOT, 1, 1)),
                            jnp.tile(g_z[None, :, None], (N_FOOT, 1, 1))],
                           axis=2)                       # (4, 5, 3)
    grad = grad * (acts * (w.cone * cnt_k)[:, None])[:, :, None]
    eye4 = jnp.eye(N_FOOT, dtype=dtype)
    cone_f = jnp.einsum("irj,ik->irkj", grad, eye4).reshape(20, 12)
    cone_Ju = jnp.concatenate([jnp.zeros((20, 18), dtype), cone_f], axis=1)

    # r_clear hinge: -(1-cnt) * w.swing_clear * (plane_z > p_z) * dp_z/dx
    clear_act = (plane_k[:, 2] - p_feet[:, 2] > 0.0).astype(dtype)
    clear_Jx = (-(1.0 - cnt_k) * w.swing_clear * clear_act)[:, None] * Jp[:, 2, :]

    zX = lambda n: jnp.zeros((n, NX), dtype)
    zU = lambda n: jnp.zeros((n, NU), dtype)
    x_parts = [
        jnp.asarray(Jx_const),   # rb, rj, ra rows (48)
        zX(12), zX(12),          # rf, rf_zero
        swing_Jx, disp_Jx, patch_Jx,
        dyn_Jx, cnt_Jx,
        zX(20),                  # cone
        clear_Jx,
    ]
    u_parts = [
        jnp.asarray(Ju_const),
        rf_Ju, rfz_Ju,
        zU(4), zU(8), zU(4),
        dyn_Ju, zU(12),
        cone_Ju,
        zU(4),
    ]
    if include_torque:
        # torque-limit hinge (AL-shifted activity — see ocp.problem)
        tau_j = tau[6:]
        t_act = hinge_shifted_act(
            jnp.abs(tau_j) - jnp.asarray(spec.torque_limit), s_tau) > 0.0
        t_scale = (t_act.astype(dtype) * jnp.sign(tau_j) * w.torque)[:, None]
        x_parts.append(t_scale * Jt_x[6:])
        u_parts.append(t_scale * jnp.concatenate(
            [Jt_a[6:], Jt_f[6:] * cnt12[None, :]], axis=1,
        ))
    return jnp.concatenate(x_parts), jnp.concatenate(u_parts)


def linearize_stages_fast(spec, w: Weights, X, U, p: OCPParams,
                          Jx_const, Ju_const, include_torque: bool = True):
    """Vectorized (r, Jx, Ju) over nodes 0..N-1 — drop-in for
    sqp._linearize_stages on the fixed-dt input layout."""
    from ..ocp.problem import stage_residual

    N = U.shape[0]

    def res_one(x, u, cnt, peak, plane, cnt_loc, patch, lam, lami):
        return stage_residual(
            spec, w, x, u, cnt, peak, plane, cnt_loc, patch,
            p.restrict, p.base_ref, p.joint_ref, p.step_height, lam_k=lam,
            lam_ineq_k=lami, include_torque=include_torque,
        )

    def jac_one(x, u, cnt, peak, plane, cnt_loc, patch, lami):
        return linearize_stage_fast(
            spec, w, x, u, cnt, peak, plane, cnt_loc, patch,
            p.restrict, p.step_height, Jx_const, Ju_const, lam_ineq_k=lami,
            include_torque=include_torque,
        )

    cnt_n = p.cnt[:, :N].T
    peak_n = p.peak[:, :N].T
    plane_n = p.plane_point[:, :N].transpose(1, 0, 2)
    loc_n = p.cnt_loc[:, :N].transpose(1, 0, 2)
    patch_n = p.patch_radius[:, :N].T
    r = jax.vmap(res_one)(X[:-1], U, cnt_n, peak_n, plane_n, loc_n, patch_n,
                          p.lam_eq, p.lam_ineq)
    Jx, Ju = jax.vmap(jac_one)(X[:-1], U, cnt_n, peak_n, plane_n, loc_n,
                               patch_n, p.lam_ineq)
    return r, Jx, Ju
