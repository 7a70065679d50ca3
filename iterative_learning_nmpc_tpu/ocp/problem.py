"""Whole-body contact-implicit OCP: declarative stage residuals.

Re-designs the reference's acados problem (`mpc_controller/utils/solver.py`,
`dynamics.py:109-134`, constraint surface at `solver.py:212-252`) as a
Gauss-Newton residual stack:

- state   x = [q(18), v(18)]          (Euler chart, v = dq/dt)
- input   u = [a(18), f(4x3)]         (chart acceleration + foot forces)
- shooting dynamics are EXACTLY linear in this chart (double integrator),
  so the SQP subproblem has constant A/B blocks; all nonlinearity lives in
  the residuals.

The acados/HPIPM hard constraints become weighted residuals (quadratic /
hinge penalties), and contact switching is *masking, not branching*: every
residual is multiplied by its activity mask so shapes stay static and the
whole stack vmaps over nodes, problems, and devices.

Residual groups (weights from MPCCostConfig / MPCOptConfig):
  base, joint, acc, swing-peak, force-reg, foot-displacement   (costs)
  centroidal-dynamics consistency (6)                          (equality pen.)
  active-contact foot velocity + height pinning (4x3)          (equality pen.)
  friction-cone hinge, swing-clearance hinge, torque hinge     (ineq. pen.)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..models import dynamics as dyn
from ..mpc.config import MPCCostConfig, MPCOptConfig
from ..robots.spec import RobotSpec

NX = 36
NU = 30
N_FOOT = 4
# Inequality-multiplier rows per node: friction-cone 4x5, torque 12, patch 4.
# The multipliers are stored as augmented-Lagrangian SHIFTS s = mu/rho >= 0 in
# PHYSICAL units (N / Nm / m): the hinge max(g, 0) becomes max(g + s, 0) and
# the dual update is s <- clip(s + g, 0, s_max) — the functional counterpart
# of HPIPM's inequality duals (reference `solver.py:290-342` warm-starts them;
# `config_abstract.py:59-74` bounds the inner QP work via max_qp_iter/qp_tol).
NC_CONE = 20
NC_TORQUE = 12
NC_PATCH = 4
NC_INEQ = NC_CONE + NC_TORQUE + NC_PATCH


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OCPParams:
    """Per-solve parameters (a pytree; batch by stacking leaves).

    Mirrors the reference's per-node parameter surface
    (`solver.py:212-275`): contact activity, plane points, peaks, contact
    location targets + restriction flag, references.
    """

    x0: jax.Array            # (NX,)
    cnt: jax.Array           # (4, N+1)  contact activity (0/1 float)
    peak: jax.Array          # (4, N+1)  swing-peak mask
    plane_point: jax.Array   # (4, N+1, 3) contact plane point (z = ground)
    cnt_loc: jax.Array       # (4, N+1, 3) target contact xy (restricted mode)
    patch_radius: jax.Array  # (4, N+1) allowed distance from cnt_loc (restricted
                             # mode; the reference's contact-patch `range_radius`,
                             # solver.py:254-275 / mpc_acyclic.py patch size)
    restrict: jax.Array      # ()  0/1: enable foot-displacement pinning
    base_ref: jax.Array      # (12,) running base reference
    base_ref_e: jax.Array    # (12,) terminal base reference
    joint_ref: jax.Array     # (12,)
    step_height: jax.Array   # ()
    dt: jax.Array            # (N,) node durations
    # Augmented-Lagrangian multipliers for the equality penalty rows
    # (dynamics consistency 6 + contact pinning 12 per node), in the weighted
    # residual space. Warm-start-shifted between solves — the role of the
    # reference's dual warm start (solver.py:290-342).
    lam_eq: jax.Array        # (N, 18)
    # AL shifts for the inequality hinge rows (cone 20 | torque 12 | patch 4
    # per node, physical units, >= 0 — see NC_* above). Updated inside
    # TrajOptSolver.solve's inner QP loop (max_qp_iter/qp_tol budget) and
    # warm-start-shifted between solves like lam_eq.
    lam_ineq: jax.Array      # (N, NC_INEQ)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Weights:
    """sqrt-weight vectors folded into the residuals."""

    base: jax.Array          # (12,)
    base_e: jax.Array        # (12,)
    joint: jax.Array         # (24,)
    joint_e: jax.Array       # (24,)
    acc: jax.Array           # (12,)
    swing: jax.Array         # (4,)
    f_reg: jax.Array         # (4, 3)
    foot_disp: jax.Array     # ()
    stab_gain: jax.Array     # (4,) contact-pin stabilization gain
    dyn_cons: jax.Array      # ()
    contact_vel: jax.Array   # ()
    cone: jax.Array          # ()
    swing_clear: jax.Array   # ()
    torque: jax.Array        # ()
    patch: jax.Array         # () patch-radius hinge
    mu: jax.Array            # () friction coefficient
    total_weight: jax.Array  # () m_total * g, for the force-reg reference
    # per-node dt optimization (active only when the input carries a dt slot)
    dt_nom: jax.Array        # () nominal node duration
    dt_min: jax.Array        # ()
    dt_max: jax.Array        # ()
    dt_reg: jax.Array        # () sqrt(time_opt weight)
    dt_bound: jax.Array      # () sqrt of the bound-hinge weight


def make_weights(
    opt: MPCOptConfig, cost: MPCCostConfig, spec: RobotSpec = None, dtype=jnp.float32
) -> Weights:
    # host-side numpy on purpose: eager jnp ops would each compile and
    # dispatch a device program (numpy leaves transfer at the jit boundary)
    import numpy as np

    npd = np.dtype(jnp.dtype(dtype).name)
    sq = lambda w: np.sqrt(np.asarray(w, dtype=npd))
    total_w = 0.0 if spec is None else 9.81 * float(np.asarray(spec.mass).sum())
    dt_nom = opt.get_dt_nodes()
    dt_min, dt_max = opt.get_dt_bounds()
    time_opt_w = float(np.atleast_1d(np.asarray(cost.time_opt))[0])
    return Weights(
        dt_nom=np.asarray(dt_nom, npd),
        dt_min=np.asarray(dt_min, npd),
        dt_max=np.asarray(dt_max, npd),
        dt_reg=sq(time_opt_w),
        dt_bound=sq(1.0e8),
        total_weight=np.asarray(total_w, dtype=npd),
        base=sq(cost.W_base),
        base_e=sq(cost.W_e_base),
        joint=sq(cost.W_joint),
        joint_e=sq(cost.W_e_joint),
        acc=sq(cost.W_acc),
        swing=sq(cost.W_swing),
        f_reg=sq(cost.W_cnt_f_reg),
        foot_disp=sq(cost.W_foot_displacement[0]),
        stab_gain=np.asarray(cost.W_foot_pos_constr_stab, dtype=npd),
        dyn_cons=sq(opt.w_dyn),
        contact_vel=sq(opt.w_contact),
        cone=sq(opt.w_cone),
        swing_clear=sq(opt.w_swing_height),
        torque=sq(opt.w_torque),
        patch=sq(opt.w_patch),
        mu=np.asarray(opt.mu, dtype=npd),
    )


def split_state(x):
    return x[:18], x[18:36]


def split_input(u):
    """(a, f) from the input vector; ignores an optional trailing dt slot."""
    return u[:18], u[18:30].reshape(N_FOOT, 3)


def input_dt(u, dt_nominal):
    """The node duration: the optional 31st input when present, else the
    nominal schedule value (reference enable_time_opt,
    config_abstract.py:49-52)."""
    if u.shape[-1] > NU:
        return u[..., NU]
    return dt_nominal


def dynamics_step(x: jax.Array, u: jax.Array, dt) -> jax.Array:
    """Double-integrator step in the chart; exact for fixed dt, bilinear
    (dt*a products) when dt is the optimized 31st input."""
    q, v = split_state(x)
    a, _ = split_input(u)
    dt = input_dt(u, dt)
    v2 = v + dt * a
    q2 = q + dt * v + 0.5 * dt * dt * a
    return jnp.concatenate([q2, v2])


def dynamics_matrices(dt, dtype=jnp.float32):
    """Constant (A, B) of the linear shooting dynamics (host numpy — see
    make_weights note on eager ops)."""
    import numpy as np

    npd = np.dtype(jnp.dtype(dtype).name)
    dt = float(dt)
    eye18 = np.eye(18, dtype=npd)
    A = np.block([[eye18, dt * eye18], [np.zeros((18, 18), npd), eye18]])
    Ba = np.concatenate([0.5 * dt * dt * eye18, dt * eye18], axis=0)
    B = np.concatenate([Ba, np.zeros((36, 12), npd)], axis=1)
    return A, B


def cone_values(f_eff, mu):
    """Raw pyramid friction-cone constraint values g <= 0, shape (4, 5):
    per-foot rows [-fz, fx - mu fz, -fx - mu fz, fy - mu fz, -fy - mu fz]
    (the reference's PointContact cone, `dynamics.py:30-32` mu=0.8 there,
    opt-config mu here)."""
    fx, fy, fz = f_eff[..., 0], f_eff[..., 1], f_eff[..., 2]
    return jnp.stack(
        [-fz, fx - mu * fz, -fx - mu * fz, fy - mu * fz, -fy - mu * fz],
        axis=-1,
    )


def hinge_shifted(g, s):
    """AL-shifted inequality residual core for g <= 0 with dual shift s >= 0.

    s == 0 (inactive estimate): plain hinge max(g, 0).
    s > 0  (active estimate):   TWO-SIDED affine residual (g + s) — the
    semismooth/active-set treatment. Same AL fixed point (dual update drives
    g -> 0), but the quadratic curvature exists on BOTH sides of the
    boundary, killing the hinge chatter a single inexact-GN step otherwise
    exhibits at active constraints (feasible pass -> zero curvature ->
    overshoot into violation -> repeat; measured as a persistent 2-cycle on
    the mu=0.25 trot before this treatment)."""
    on = jnp.asarray(s > 0.0, g.dtype)
    return on * (g + s) + (1.0 - on) * jnp.maximum(g, 0.0)


def hinge_shifted_act(g, s):
    """Activity mask matching hinge_shifted's derivative: 1 where s > 0
    (two-sided affine row), else the plain hinge activity (g > 0)."""
    on = jnp.asarray(s > 0.0, g.dtype)
    return on + (1.0 - on) * jnp.asarray(g > 0.0, g.dtype)


def _base_joint_residuals(x, base_ref, joint_ref, w_base, w_joint):
    q, v = split_state(x)
    rb = jnp.concatenate([q[:6] - base_ref[:6], v[:6] - base_ref[6:]]) * w_base
    rj = jnp.concatenate([q[6:] - joint_ref, v[6:]]) * w_joint
    return rb, rj


def stage_residual(
    spec: RobotSpec,
    w: Weights,
    x: jax.Array,
    u: jax.Array,
    cnt_k: jax.Array,        # (4,)
    peak_k: jax.Array,       # (4,)
    plane_k: jax.Array,      # (4, 3)
    cnt_loc_k: jax.Array,    # (4, 3)
    patch_k: jax.Array,      # (4,) patch radii
    restrict: jax.Array,     # ()
    base_ref: jax.Array,
    joint_ref: jax.Array,
    step_height: jax.Array,
    lam_k: jax.Array = None,   # (18,) AL multipliers (weighted space)
    lam_ineq_k: jax.Array = None,  # (NC_INEQ,) AL hinge shifts (physical)
    include_torque: bool = True,
) -> jax.Array:
    """All running residuals for one node, concatenated (static length).

    include_torque=False drops the torque-limit hinge rows — used for the QP
    linearization (RTI-style inexact SQP): the hinge is almost always
    inactive, in which case its Gauss-Newton contribution is exactly zero,
    but differentiating it costs a full RNEA tangent sweep per node. The
    merit function (full residual) still penalizes violations, so the line
    search rejects steps that would activate the limits.
    """
    q, v = split_state(x)
    a, f = split_input(u)
    f_eff = cnt_k[:, None] * f  # forces exist only at active contacts

    # --- tracking costs (reference dynamics.py:121-134) ---
    rb, rj = _base_joint_residuals(x, base_ref, joint_ref, w.base, w.joint)
    ra = a[6:] * w.acc
    # force regularization toward the per-node gravity share (not zero —
    # regularizing to zero makes carrying the body "expensive" and the
    # horizon tail sags; acados hides this behind hard dynamics constraints)
    n_active = jnp.maximum(jnp.sum(cnt_k), 1.0)
    f_ref = jnp.zeros_like(f_eff).at[:, 2].set(cnt_k * w.total_weight / n_active)
    rf = ((f_eff - f_ref) * w.f_reg).reshape(-1)
    # pin swing-phase force decision variables at zero (they are masked out of
    # the dynamics anyway; this keeps the GN input-Hessian well conditioned)
    rf_zero = ((1.0 - cnt_k[:, None]) * f).reshape(-1)

    p_feet = dyn.foot_positions(spec, q)
    v_feet = dyn.foot_velocities(spec, q, v)

    # swing-peak height cost: peak * (z - step_height)  (dynamics.py:132-134)
    r_swing = peak_k * (p_feet[:, 2] - step_height) * w.swing

    # foot displacement from the planned contact point (restricted mode,
    # solver.py:254-275 + W_foot_displacement)
    r_disp = (
        restrict * cnt_k[:, None] * (p_feet[:, :2] - cnt_loc_k[:, :2])
    ).reshape(-1) * w.foot_disp

    # hard contact-patch restriction: hinge on the distance of an active
    # foot from the patch center beyond the patch radius (the reference's
    # acados `range_radius` inequality, solver.py:254-275) — inside the
    # patch the foot is free; the quadratic r_disp above is the soft pull
    d_xy = p_feet[:, :2] - cnt_loc_k[:, :2]
    dist = jnp.sqrt(jnp.sum(d_xy * d_xy, axis=1) + 1.0e-12)
    gap_patch = dist - patch_k
    if lam_ineq_k is not None:
        r_patch_core = hinge_shifted(gap_patch,
                                     lam_ineq_k[NC_CONE + NC_TORQUE:])
    else:
        r_patch_core = jnp.maximum(gap_patch, 0.0)
    r_patch = restrict * cnt_k * r_patch_core * w.patch

    # --- whole-body dynamics consistency on the unactuated base rows ---
    # rnea(q,v,a,f)[0:6] == 0 is exactly the centroidal-momentum balance
    # hdot(q,v,a) == contact wrench (same 6 Newton-Euler equations in the
    # chart basis); ONE shared RNEA pass also yields the joint torques for
    # the torque-limit rows — this replaces the reference's separate
    # h-dynamics constraint + CasADi torque expressions.
    tau_full = dyn.rnea(spec, q, v, a, f_ext_feet=f_eff)
    r_dyn = tau_full[:6] * w.dyn_cons
    if lam_k is not None:
        r_dyn = r_dyn + lam_k[:6]

    # --- contact pinning: active feet don't move; height pinned to the plane
    #     with Baumgarte gain (PointContact + p_gain, solver.py:219) ---
    pin_xy = v_feet[:, :2]
    pin_z = v_feet[:, 2] + w.stab_gain * (p_feet[:, 2] - plane_k[:, 2])
    r_cnt = (cnt_k[:, None] * jnp.concatenate([pin_xy, pin_z[:, None]], axis=1)
             ).reshape(-1) * w.contact_vel
    if lam_k is not None:
        # multipliers only act on active-contact rows
        r_cnt = r_cnt + jnp.repeat(cnt_k, 3) * lam_k[6:]

    # --- friction cone (pyramid) hinge: |f_xy| <= mu f_z, f_z >= 0 ---
    # AL dual shifts (hinge_shifted): at the annealed fixed point the true
    # violation goes to ~0 (the bounded-violation role of HPIPM's
    # interior-point iterations). Shifts are masked by cnt so swing nodes
    # (vacuous cone) contribute no constant residual.
    g_cone = cone_values(f_eff, w.mu)
    if lam_ineq_k is not None:
        s_c = cnt_k[:, None] * lam_ineq_k[:NC_CONE].reshape(4, 5)
        cone = hinge_shifted(g_cone, s_c).reshape(-1) * w.cone
    else:
        cone = jnp.maximum(g_cone, 0.0).reshape(-1) * w.cone

    # --- swing feet stay above the ground plane ---
    r_clear = (1.0 - cnt_k) * jnp.maximum(plane_k[:, 2] - p_feet[:, 2], 0.0) * w.swing_clear

    parts = [rb, rj, ra, rf, rf_zero, r_swing, r_disp, r_patch, r_dyn, r_cnt,
             cone, r_clear]

    if u.shape[-1] > NU:
        # per-node dt optimization: regularize toward the nominal schedule
        # (cost `time_opt`, solver.py:124-125) and bound dt via hinges
        # (opt_dt_scale, config_abstract.py:80-88)
        dt_k = u[NU]
        parts.append((dt_k - w.dt_nom)[None] * w.dt_reg)
        parts.append(jnp.maximum(w.dt_min - dt_k, 0.0)[None] * w.dt_bound)
        parts.append(jnp.maximum(dt_k - w.dt_max, 0.0)[None] * w.dt_bound)

    if include_torque:
        # --- torque limits, from the same RNEA pass (config_abstract.py:67-69) ---
        g_tau = jnp.abs(tau_full[6:]) - spec.torque_limit
        if lam_ineq_k is not None:
            r_tau = hinge_shifted(g_tau,
                                  lam_ineq_k[NC_CONE:NC_CONE + NC_TORQUE])
        else:
            r_tau = jnp.maximum(g_tau, 0.0)
        parts.append(r_tau * w.torque)

    return jnp.concatenate(parts)


def terminal_residual(
    spec: RobotSpec,
    w: Weights,
    x: jax.Array,
    peak_k: jax.Array,
    base_ref_e: jax.Array,
    joint_ref: jax.Array,
    step_height: jax.Array,
) -> jax.Array:
    q, v = split_state(x)
    rb, rj = _base_joint_residuals(x, base_ref_e, joint_ref, w.base_e, w.joint_e)
    p_feet = dyn.foot_positions(spec, q)
    r_swing = peak_k * (p_feet[:, 2] - step_height) * w.swing
    return jnp.concatenate([rb, rj, r_swing])


def stage_residual_from_params(spec, w, x, u, p: OCPParams, k: int):
    """Convenience indexer used by vmapped linearization."""
    return stage_residual(
        spec, w, x, u,
        p.cnt[:, k], p.peak[:, k], p.plane_point[:, k], p.cnt_loc[:, k],
        p.patch_radius[:, k],
        p.restrict, p.base_ref, p.joint_ref, p.step_height, p.lam_eq[k],
        p.lam_ineq[k],
    )


def equality_residuals(spec: RobotSpec, w: Weights, x, u, cnt_k, plane_k,
                       core: Tuple[jax.Array, ...] = None):
    """The bare (multiplier-free) equality penalty rows, weighted: used for
    the AL multiplier update lam <- clip(lam + r_eq).

    `core`, when given, is (p_feet (4,3), v_feet (4,3), tau_full (18))
    already evaluated by the caller (`TrajOptSolver._dual_g` shares one
    FK/RNEA pass between these rows and `ineq_values`)."""
    q, v = split_state(x)
    a, f = split_input(u)
    f_eff = cnt_k[:, None] * f
    if core is None:
        tau_full = dyn.rnea(spec, q, v, a, f_ext_feet=f_eff)
        p_feet = dyn.foot_positions(spec, q)
        v_feet = dyn.foot_velocities(spec, q, v)
    else:
        p_feet, v_feet, tau_full = core
    r_dyn = tau_full[:6] * w.dyn_cons
    pin_xy = v_feet[:, :2]
    pin_z = v_feet[:, 2] + w.stab_gain * (p_feet[:, 2] - plane_k[:, 2])
    r_cnt = (cnt_k[:, None] * jnp.concatenate([pin_xy, pin_z[:, None]], axis=1)
             ).reshape(-1) * w.contact_vel
    return jnp.concatenate([r_dyn, r_cnt])


def ineq_values(spec: RobotSpec, w: Weights, x, u, cnt_k, cnt_loc_k, patch_k,
                restrict, core: Tuple[jax.Array, jax.Array] = None):
    """Raw inequality constraint values g (NC_INEQ,) for one node, in
    PHYSICAL units (cone rows in N, torque rows in Nm, patch rows in m),
    ordered [cone 20 | torque 12 | patch 4] like OCPParams.lam_ineq.

    Cone rows are evaluated on f_eff = cnt*f so swing nodes read 0; patch
    rows carry the restrict*cnt vacuity mask. Used by the AL dual update
    s <- clip(s + g, 0, s_max) and the qp_tol violation metric
    (TrajOptSolver.update_ineq_multipliers).

    `core`, when given, is (p_feet (4,3), tau_full (18)) already evaluated
    by the caller (see `equality_residuals`)."""
    q, v = split_state(x)
    a, f = split_input(u)
    f_eff = cnt_k[:, None] * f
    if core is None:
        p_feet = dyn.foot_positions(spec, q)
        tau_full = dyn.rnea(spec, q, v, a, f_ext_feet=f_eff)
    else:
        p_feet, tau_full = core
    g_cone = cone_values(f_eff, w.mu).reshape(-1)
    g_tau = jnp.abs(tau_full[6:]) - spec.torque_limit
    d_xy = p_feet[:, :2] - cnt_loc_k[:, :2]
    dist = jnp.sqrt(jnp.sum(d_xy * d_xy, axis=1) + 1.0e-12)
    g_patch = restrict * cnt_k * (dist - patch_k)
    return jnp.concatenate([g_cone, g_tau, g_patch])
