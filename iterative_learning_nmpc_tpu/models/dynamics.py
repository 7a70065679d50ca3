"""Structured quadruped rigid-body dynamics — the production compute path.

Accelerator re-design of the generic tree recursion (models/tree_dynamics.py):
the floating base is handled analytically in the Euler chart and the four
legs — structurally identical 3-revolute chains — are evaluated with
`jax.vmap` over the leg axis. Compared to the per-body unrolled tree this
shrinks the XLA graph ~10x (XLA builds scalar-soup graphs slowly) and
turns the leg math into vector code.

Replaces Pinocchio's FK/RNEA/Jacobian/CoM/centroidal kernels
(`mpc_controller/utils/dynamics.py:48-163` in the reference) and matches
models/tree_dynamics.py (the structure-agnostic oracle) to fp32 precision —
pinned by tests/test_structured_dynamics.py.

Conventions: world-frame Newton-Euler; chart q = [pos, ypr, joints],
v = dq/dt; gravity enters as a fictitious upward base acceleration.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..robots.spec import RobotSpec
from .math3d import (
    euler_rate_to_local_angular,
    rotation_about_axis,
    ypr_to_matrix,
)

GRAVITY = 9.81


class FK(NamedTuple):
    R: jax.Array      # (nv, 3, 3)
    p: jax.Array      # (nv, 3)
    w: jax.Array      # (nv, 3) world angular velocity
    vlin: jax.Array   # (nv, 3) world linear velocity of body origin


class _LegKin(NamedTuple):
    """World-frame kinematics of all 4 legs, leg-stacked (leading dim 4)."""

    R: jax.Array       # (4, 3, 3, 3) link rotations
    p: jax.Array       # (4, 3, 3) link origins
    axis_w: jax.Array  # (4, 3, 3) world joint axes
    w: jax.Array       # (4, 3, 3) link angular velocities
    v: jax.Array       # (4, 3, 3) link origin linear velocities
    p_foot: jax.Array  # (4, 3)
    v_foot: jax.Array  # (4, 3)


def _leg_arrays(spec: RobotSpec):
    jp = spec.joint_pos[6:].reshape(4, 3, 3)
    ax = spec.joint_axis[6:].reshape(4, 3, 3)
    m = spec.mass[6:].reshape(4, 3)
    com = spec.com[6:].reshape(4, 3, 3)
    Ic = spec.inertia[6:].reshape(4, 3, 3, 3)
    return jp, ax, m, com, Ic


def _base_pose(spec: RobotSpec, q):
    return ypr_to_matrix(q[3:6]), q[:3]


def _base_angular_velocity_world(ypr, ypr_rate):
    return ypr_to_matrix(ypr) @ euler_rate_to_local_angular(ypr, ypr_rate)


def _leg_kinematics(spec: RobotSpec, q, v=None) -> Tuple:
    """Vmapped world-frame FK (+velocities) of the 4 legs."""
    jp, ax, *_ = _leg_arrays(spec)
    R_b, p_b = _base_pose(spec, q)
    q_legs = q[6:].reshape(4, 3)
    if v is None:
        w_b = vb = qd_legs = None
    else:
        w_b = _base_angular_velocity_world(q[3:6], v[3:6])
        vb = v[:3]
        qd_legs = v[6:].reshape(4, 3)

    def leg(jp_l, ax_l, q_l, qd_l, foot_off):
        Rs, ps, axs, ws, vs = [], [], [], [], []
        R_p, p_p = R_b, p_b
        w_p = w_b if v is not None else None
        v_p = vb if v is not None else None
        for k in range(3):
            a_w = R_p @ ax_l[k]
            R_k = R_p @ rotation_about_axis(ax_l[k], q_l[k])
            p_k = p_p + R_p @ jp_l[k]
            Rs.append(R_k)
            ps.append(p_k)
            axs.append(a_w)
            if v is not None:
                v_k = v_p + jnp.cross(w_p, p_k - p_p)
                w_k = w_p + a_w * qd_l[k]
                ws.append(w_k)
                vs.append(v_k)
                w_p, v_p = w_k, v_k
            R_p, p_p = R_k, p_k
        p_f = ps[2] + Rs[2] @ foot_off
        if v is not None:
            v_f = vs[2] + jnp.cross(ws[2], p_f - ps[2])
        else:
            v_f = p_f * 0.0
        zeros = [p_f * 0.0] * 3
        return (
            jnp.stack(Rs), jnp.stack(ps), jnp.stack(axs),
            jnp.stack(ws if v is not None else zeros),
            jnp.stack(vs if v is not None else zeros),
            p_f, v_f,
        )

    out = jax.vmap(leg)(jp, ax, q_legs,
                        qd_legs if v is not None else jnp.zeros((4, 3), q.dtype),
                        spec.foot_offset)
    return _LegKin(*out)


# ---------------------------------------------------------------------------
# Public API (same surface as tree_dynamics)
# ---------------------------------------------------------------------------

def foot_positions(spec: RobotSpec, q: jax.Array) -> jax.Array:
    lk = _leg_kinematics(spec, q)
    return lk.p_foot


def foot_velocities(spec: RobotSpec, q: jax.Array, v: jax.Array) -> jax.Array:
    lk = _leg_kinematics(spec, q, v)
    return lk.v_foot


def foot_jacobians(spec: RobotSpec, q: jax.Array) -> jax.Array:
    """(4, 3, nv) world-aligned linear foot Jacobians (= dp_foot/dq)."""
    return jax.jacfwd(lambda qq: foot_positions(spec, qq))(q)


def fk_pos(spec: RobotSpec, q: jax.Array):
    """(nv,3,3), (nv,3) world body poses; dummy base bodies carry the base
    pose (massless — only trunk/leg entries are meaningful)."""
    R_b, p_b = _base_pose(spec, q)
    lk = _leg_kinematics(spec, q)
    R = jnp.concatenate([jnp.tile(R_b[None], (6, 1, 1)), lk.R.reshape(12, 3, 3)])
    p = jnp.concatenate([jnp.tile(p_b[None], (6, 1)), lk.p.reshape(12, 3)])
    return R, p


def fk_vel(spec: RobotSpec, q: jax.Array, v: jax.Array) -> FK:
    R_b, p_b = _base_pose(spec, q)
    w_b = _base_angular_velocity_world(q[3:6], v[3:6])
    lk = _leg_kinematics(spec, q, v)
    R = jnp.concatenate([jnp.tile(R_b[None], (6, 1, 1)), lk.R.reshape(12, 3, 3)])
    p = jnp.concatenate([jnp.tile(p_b[None], (6, 1)), lk.p.reshape(12, 3)])
    w = jnp.concatenate([jnp.tile(w_b[None], (6, 1)), lk.w.reshape(12, 3)])
    vl = jnp.concatenate([jnp.tile(v[:3][None], (6, 1)), lk.v.reshape(12, 3)])
    return FK(R, p, w, vl)


def rnea(
    spec: RobotSpec,
    q: jax.Array,
    v: jax.Array,
    a: jax.Array,
    f_ext_feet: Optional[jax.Array] = None,
    gravity: float = GRAVITY,
) -> jax.Array:
    """World-frame Newton-Euler inverse dynamics:
    tau = M(q) a + C(q,v) v + g(q) - J^T f_ext."""
    dtype = q.dtype
    jp, ax, m_legs, com_legs, Ic_legs = _leg_arrays(spec)
    R_b, p_b = _base_pose(spec, q)
    ypr, ypr_d, ypr_dd = q[3:6], v[3:6], a[3:6]
    w_b = _base_angular_velocity_world(ypr, ypr_d)
    # d/dt of the (ypr, yprdot) -> world angular velocity map (tiny jvp)
    _, dw_b = jax.jvp(
        _base_angular_velocity_world, (ypr, ypr_d), (ypr_d, ypr_dd)
    )
    v_b = v[:3]
    dv_b = a[:3] + jnp.array([0.0, 0.0, gravity], dtype=dtype)  # gravity trick

    q_legs = q[6:].reshape(4, 3)
    qd_legs = v[6:].reshape(4, 3)
    qdd_legs = a[6:].reshape(4, 3)

    def leg(jp_l, ax_l, q_l, qd_l, qdd_l, m_l, c_l, I_l, foot_off, f_ext):
        R_p, p_p, w_p, v_p, dw_p, dv_p = R_b, p_b, w_b, v_b, dw_b, dv_b
        Fs, Ms = [], []          # link forces and moments-about-origin
        pjs, axs = [], []
        for k in range(3):
            a_w = R_p @ ax_l[k]
            R_k = R_p @ rotation_about_axis(ax_l[k], q_l[k])
            p_k = p_p + R_p @ jp_l[k]
            r = p_k - p_p
            v_k = v_p + jnp.cross(w_p, r)
            dv_k = dv_p + jnp.cross(dw_p, r) + jnp.cross(w_p, jnp.cross(w_p, r))
            w_k = w_p + a_w * qd_l[k]
            dw_k = dw_p + a_w * qdd_l[k] + jnp.cross(w_p, a_w * qd_l[k])
            # Newton-Euler about the link CoM
            c_w = R_k @ c_l[k]
            x_c = p_k + c_w
            a_c = dv_k + jnp.cross(dw_k, c_w) + jnp.cross(w_k, jnp.cross(w_k, c_w))
            I_w = R_k @ I_l[k] @ R_k.T
            F = m_l[k] * a_c
            N = I_w @ dw_k + jnp.cross(w_k, I_w @ w_k)
            Fs.append(F)
            Ms.append(N + jnp.cross(x_c, F))  # moment about the world origin
            pjs.append(p_k)
            axs.append(a_w)
            R_p, p_p, w_p, v_p, dw_p, dv_p = R_k, p_k, w_k, v_k, dw_k, dv_k

        # external foot force (world) applied at the foot point
        p_f = pjs[2] + R_p @ foot_off
        Fs.append(-f_ext)
        Ms.append(jnp.cross(p_f, -f_ext))

        F_stack = jnp.stack(Fs)           # (4, 3) incl. ext
        M_stack = jnp.stack(Ms)
        # reverse partial sums: joint k supports links k..2 (+ext)
        tau_l = []
        for k in range(3):
            S_F = F_stack[k:].sum(0)
            S_M = M_stack[k:].sum(0)
            tau_l.append(axs[k] @ (S_M - jnp.cross(pjs[k], S_F)))
        return jnp.stack(tau_l), F_stack.sum(0), M_stack.sum(0)

    f_ext = (
        f_ext_feet.astype(dtype)
        if f_ext_feet is not None
        else jnp.zeros((4, 3), dtype)
    )
    tau_legs, F_legs, M_legs = jax.vmap(leg)(
        jp, ax, q_legs, qd_legs, qdd_legs, m_legs, com_legs, Ic_legs,
        spec.foot_offset, f_ext,
    )

    # trunk Newton-Euler
    m_t = spec.mass[5]
    c_w = R_b @ spec.com[5]
    x_c = p_b + c_w
    a_c = dv_b + jnp.cross(dw_b, c_w) + jnp.cross(w_b, jnp.cross(w_b, c_w))
    I_w = R_b @ spec.inertia[5] @ R_b.T
    F_t = m_t * a_c
    M_t = I_w @ dw_b + jnp.cross(w_b, I_w @ w_b) + jnp.cross(x_c, F_t)

    F_tot = F_t + F_legs.sum(0)
    M_tot = M_t + M_legs.sum(0)                      # about world origin
    n_base_w = M_tot - jnp.cross(p_b, F_tot)          # about base origin
    # chart generalized forces: world force on the prismatic coords, and the
    # euler-rate dual map on the angular coords (tau_ypr = E^T R^T n_w)
    n_local = R_b.T @ n_base_w
    E = jax.jacfwd(lambda rate: euler_rate_to_local_angular(ypr, rate))(
        jnp.zeros(3, dtype)
    )
    tau_base = jnp.concatenate([F_tot, E.T @ n_local])
    return jnp.concatenate([tau_base, tau_legs.reshape(12)])


def bias_forces(spec: RobotSpec, q, v):
    return rnea(spec, q, v, jnp.zeros_like(v))


def mass_matrix(spec: RobotSpec, q: jax.Array) -> jax.Array:
    eye = jnp.eye(spec.nv, dtype=q.dtype)
    zero = jnp.zeros(spec.nv, dtype=q.dtype)
    cols = jax.vmap(lambda e: rnea(spec, q, zero, e, gravity=0.0))(eye)
    return 0.5 * (cols + cols.T)


def id_torques(spec: RobotSpec, q, v, a, f_feet) -> jax.Array:
    """Feed-forward joint torques (reference `dynamics.py:136-163`)."""
    return rnea(spec, q, v, a, f_ext_feet=f_feet)[6:]


def _massive_bodies(spec: RobotSpec, q, v):
    """(13, ...) stacked world kinematics+inertia of trunk + 12 leg links."""
    fk = fk_vel(spec, q, v)
    idx = jnp.arange(5, 18)
    return (
        fk.R[idx], fk.p[idx], fk.w[idx], fk.vlin[idx],
        spec.mass[5:], spec.com[5:], spec.inertia[5:],
    )


def com_position(spec: RobotSpec, q: jax.Array) -> jax.Array:
    R, p = fk_pos(spec, q)
    x_com = p[5:] + jnp.einsum("nij,nj->ni", R[5:], spec.com[5:])
    m = spec.mass[5:]
    return (m[:, None] * x_com).sum(0) / m.sum()


def centroidal_momentum(spec: RobotSpec, q, v) -> jax.Array:
    """h = [linear, angular] about the CoM, world-aligned."""
    R, p, w, vl, m, c, Ic = _massive_bodies(spec, q, v)
    c_body = jnp.einsum("nij,nj->ni", R, c)
    x_com = p + c_body
    v_com = vl + jnp.cross(w, c_body)
    mm = m[:, None]
    lin = (mm * v_com).sum(0)
    com = (mm * x_com).sum(0) / m.sum()
    I_w = jnp.einsum("nij,njk,nlk->nil", R, Ic, R)
    ang = (jnp.einsum("nij,nj->ni", I_w, w) + jnp.cross(x_com - com, mm * v_com)).sum(0)
    return jnp.concatenate([lin, ang])


def centroidal_momentum_rate(spec: RobotSpec, q, v, a) -> jax.Array:
    _, hdot = jax.jvp(lambda qq, vv: centroidal_momentum(spec, qq, vv), (q, v), (v, a))
    return hdot


def contact_wrench_about_com(spec: RobotSpec, q, f_feet, gravity: float = GRAVITY):
    c = com_position(spec, q)
    p_feet = foot_positions(spec, q)
    m_tot = spec.mass.sum()
    lin = f_feet.sum(0) + m_tot * jnp.array([0.0, 0.0, -gravity], dtype=q.dtype)
    ang = jnp.cross(p_feet - c, f_feet).sum(0)
    return jnp.concatenate([lin, ang])


def forward_dynamics(spec: RobotSpec, q, v, tau_joints, f_ext_feet=None):
    tau_full = jnp.concatenate([jnp.zeros(6, dtype=q.dtype), tau_joints])
    rhs = tau_full - rnea(spec, q, v, jnp.zeros_like(v), f_ext_feet=f_ext_feet)
    M = mass_matrix(spec, q)
    L = jnp.linalg.cholesky(M)
    y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
