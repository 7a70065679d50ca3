"""Generic kinematic-tree rigid-body dynamics (reference implementation).

This is the arbitrary-tree version: correct for any RobotSpec but compiles to
large scalar graphs (one unrolled block per body) that XLA is slow to
build. The production path is models/dynamics.py, which exploits
the quadruped structure (analytic floating base + 4 identical legs vmapped).
Kept as the structure-agnostic oracle for tests and future morphologies.

Replaces Pinocchio (FK at `mpc_controller/utils/dynamics.py:49`, RNEA at
`dynamics.py:156`, frame Jacobians at `dynamics.py:160`, centroidal momentum at
`dynamics.py:50`) with handwritten FK/RNEA recursions plus AD-derived
quantities — mass matrix, CMM and momentum rate come from vmap/jvp instead of
symbolic codegen (the CasADi role in the reference).

Everything here takes single (q, v, ...) vectors; batch via `jax.vmap`.
All loops are over a static body count (18) and unroll at trace time —
XLA fuses them into straight-line vector code, which is the accelerator-
friendly shape for these tiny per-body ops. The batch dimension is where the parallelism is.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..robots.spec import PRISMATIC, REVOLUTE, RobotSpec
from .math3d import rotation_about_axis

GRAVITY = 9.81


class FK(NamedTuple):
    """World-frame forward-kinematics result per body."""

    R: jax.Array      # (nv, 3, 3) body orientation
    p: jax.Array      # (nv, 3)    body origin position
    w: jax.Array      # (nv, 3)    world angular velocity
    vlin: jax.Array   # (nv, 3)    world linear velocity of body origin


def fk_pos(spec: RobotSpec, q: jax.Array):
    """Forward kinematics: world pose of every body frame."""
    Rs, ps = [], []
    for i in range(spec.nv):
        par = spec.parent[i]
        Rp = Rs[par] if par >= 0 else jnp.eye(3, dtype=q.dtype)
        pp = ps[par] if par >= 0 else jnp.zeros(3, dtype=q.dtype)
        axis = spec.joint_axis[i]
        off = spec.joint_pos[i]
        if spec.jtype[i] == PRISMATIC:
            Rs.append(Rp)
            ps.append(pp + Rp @ (off + axis * q[i]))
        else:  # REVOLUTE
            Rs.append(Rp @ rotation_about_axis(axis, q[i]))
            ps.append(pp + Rp @ off)
    return jnp.stack(Rs), jnp.stack(ps)


def fk_vel(spec: RobotSpec, q: jax.Array, v: jax.Array) -> FK:
    """FK with world-frame body velocities."""
    Rs, ps, ws, vs = [], [], [], []
    for i in range(spec.nv):
        par = spec.parent[i]
        Rp = Rs[par] if par >= 0 else jnp.eye(3, dtype=q.dtype)
        pp = ps[par] if par >= 0 else jnp.zeros(3, dtype=q.dtype)
        wp = ws[par] if par >= 0 else jnp.zeros(3, dtype=q.dtype)
        vp = vs[par] if par >= 0 else jnp.zeros(3, dtype=q.dtype)
        axis = spec.joint_axis[i]
        off = spec.joint_pos[i]
        if spec.jtype[i] == PRISMATIC:
            Ri = Rp
            pi = pp + Rp @ (off + axis * q[i])
            wi = wp
            vi = vp + jnp.cross(wp, pi - pp) + (Rp @ axis) * v[i]
        else:
            Ri = Rp @ rotation_about_axis(axis, q[i])
            pi = pp + Rp @ off
            wi = wp + (Rp @ axis) * v[i]
            vi = vp + jnp.cross(wp, pi - pp)
        Rs.append(Ri)
        ps.append(pi)
        ws.append(wi)
        vs.append(vi)
    return FK(jnp.stack(Rs), jnp.stack(ps), jnp.stack(ws), jnp.stack(vs))


def foot_positions(spec: RobotSpec, q: jax.Array) -> jax.Array:
    """(4, 3) world positions of the foot points (mirrors
    `QuadrupedDynamics.get_feet_position_w`, `dynamics.py:101-107`)."""
    R, p = fk_pos(spec, q)
    fb = jnp.array(spec.foot_body)
    return p[fb] + jnp.einsum("fij,fj->fi", R[fb], spec.foot_offset)


def foot_velocities(spec: RobotSpec, q: jax.Array, v: jax.Array) -> jax.Array:
    """(4, 3) world linear velocities of the foot points."""
    f = fk_vel(spec, q, v)
    fb = jnp.array(spec.foot_body)
    r = jnp.einsum("fij,fj->fi", f.R[fb], spec.foot_offset)
    return f.vlin[fb] + jnp.cross(f.w[fb], r)


def foot_jacobians(spec: RobotSpec, q: jax.Array) -> jax.Array:
    """(4, 3, nv) world-aligned linear foot Jacobians: dp_foot/dq.

    In the Euler chart v = dq/dt, so this equals pinocchio's
    LOCAL_WORLD_ALIGNED linear frame Jacobian used at `dynamics.py:160`.
    """
    return jax.jacfwd(lambda qq: foot_positions(spec, qq))(q)


def rnea(
    spec: RobotSpec,
    q: jax.Array,
    v: jax.Array,
    a: jax.Array,
    f_ext_feet: Optional[jax.Array] = None,
    gravity: float = GRAVITY,
) -> jax.Array:
    """Recursive Newton-Euler inverse dynamics in body coordinates.

    tau = M(q) a + C(q,v) v + g(q) - sum_i J_i^T f_i  (all nv rows).

    Args:
      f_ext_feet: optional (4, 3) world-frame contact forces applied at the
        foot points (the reference subtracts f^T J_ee per foot at
        `dynamics.py:156-161`; here the forces enter the recursion directly,
        which is cheaper than forming Jacobians).
    Returns:
      (nv,) generalized forces. Rows 0:6 are the (unactuated) base rows.
    """
    dtype = q.dtype
    zero3 = jnp.zeros(3, dtype=dtype)
    g_acc = jnp.array([0.0, 0.0, gravity], dtype=dtype)  # fictitious base accel

    # forward pass: body-frame motion
    R_pc, r_pc = [], []       # child->parent rotation, child origin in parent frame
    w, vlin, dw, dv = [], [], [], []
    for i in range(spec.nv):
        par = spec.parent[i]
        axis = spec.joint_axis[i]
        off = spec.joint_pos[i]
        wp = w[par] if par >= 0 else zero3
        vp = vlin[par] if par >= 0 else zero3
        dwp = dw[par] if par >= 0 else zero3
        dvp = dv[par] if par >= 0 else g_acc
        if spec.jtype[i] == PRISMATIC:
            Rj = jnp.eye(3, dtype=dtype)
            rj = off + axis * q[i]
        else:
            Rj = rotation_about_axis(axis, q[i])
            rj = off
        RT = Rj.T
        wi = RT @ wp
        vi = RT @ (vp + jnp.cross(wp, rj))
        dwi = RT @ dwp
        dvi = RT @ (dvp + jnp.cross(dwp, rj))
        if spec.jtype[i] == PRISMATIC:
            si_lin = axis
            vi = vi + si_lin * v[i]
            dvi = dvi + si_lin * a[i] + jnp.cross(wi, si_lin * v[i])
        else:
            wi_j = axis * v[i]
            # velocity-product term v x S qd before adding joint rate
            dwi = dwi + axis * a[i] + jnp.cross(wi, wi_j)
            dvi = dvi + jnp.cross(vi, wi_j)
            wi = wi + wi_j
        R_pc.append(Rj)
        r_pc.append(rj)
        w.append(wi)
        vlin.append(vi)
        dw.append(dwi)
        dv.append(dvi)

    # body wrenches: f = I a + v x* I v  (couple n, force f at body origin)
    n_b, f_b = [], []
    for i in range(spec.nv):
        m = spec.mass[i]
        c = spec.com[i]
        Ic = spec.inertia[i]
        # Newton-Euler about the CoM, then shift the wrench to the body origin.
        # (dw, dv) is the *spatial* acceleration; the classical acceleration of
        # the CoM point adds the w x v convection term:
        acc_com = (
            dv[i]
            + jnp.cross(w[i], vlin[i])
            + jnp.cross(dw[i], c)
            + jnp.cross(w[i], jnp.cross(w[i], c))
        )
        F = m * acc_com
        N = Ic @ dw[i] + jnp.cross(w[i], Ic @ w[i]) + jnp.cross(c, F)
        n_b.append(N)
        f_b.append(F)

    # external foot forces (world) -> body wrench on the foot's body
    if f_ext_feet is not None:
        Rw, _ = None, None
        fkr = fk_pos(spec, q)
        Rw = fkr[0]
        for k, body in enumerate(spec.foot_body):
            f_loc = Rw[body].T @ f_ext_feet[k]
            n_b[body] = n_b[body] - jnp.cross(spec.foot_offset[k], f_loc)
            f_b[body] = f_b[body] - f_loc

    # backward pass
    tau = [None] * spec.nv
    for i in range(spec.nv - 1, -1, -1):
        axis = spec.joint_axis[i]
        if spec.jtype[i] == PRISMATIC:
            tau[i] = axis @ f_b[i]
        else:
            tau[i] = axis @ n_b[i]
        par = spec.parent[i]
        if par >= 0:
            Rj, rj = R_pc[i], r_pc[i]
            f_p = Rj @ f_b[i]
            n_p = Rj @ n_b[i] + jnp.cross(rj, f_p)
            n_b[par] = n_b[par] + n_p
            f_b[par] = f_b[par] + f_p
    return jnp.stack(tau)


def bias_forces(spec: RobotSpec, q: jax.Array, v: jax.Array) -> jax.Array:
    """C(q,v) v + g(q)."""
    return rnea(spec, q, v, jnp.zeros_like(v))


def mass_matrix(spec: RobotSpec, q: jax.Array) -> jax.Array:
    """(nv, nv) joint-space inertia matrix via the unit-vector RNEA method
    (vmapped columns; replaces CRBA — same result, trivially batched)."""
    eye = jnp.eye(spec.nv, dtype=q.dtype)
    zero = jnp.zeros(spec.nv, dtype=q.dtype)
    cols = jax.vmap(lambda e: rnea(spec, q, zero, e, gravity=0.0))(eye)
    return cols.T


def id_torques(
    spec: RobotSpec, q: jax.Array, v: jax.Array, a: jax.Array, f_feet: jax.Array
) -> jax.Array:
    """Actuated-joint feed-forward torques for a planned (q, v, a, forces):
    tau = rnea(q,v,a)[-nu:] - sum f^T J  (reference `dynamics.py:136-163`)."""
    return rnea(spec, q, v, a, f_ext_feet=f_feet)[6:]


def com_position(spec: RobotSpec, q: jax.Array) -> jax.Array:
    R, p = fk_pos(spec, q)
    x_com = p + jnp.einsum("nij,nj->ni", R, spec.com)
    return (spec.mass[:, None] * x_com).sum(0) / spec.mass.sum()


def centroidal_momentum(spec: RobotSpec, q: jax.Array, v: jax.Array) -> jax.Array:
    """h = [linear(3), angular(3)] about the CoM, world-aligned frame
    (pinocchio `hg` layout, reference `solver.py:187`)."""
    f = fk_vel(spec, q, v)
    c_body = jnp.einsum("nij,nj->ni", f.R, spec.com)
    x_com = f.p + c_body
    v_com = f.vlin + jnp.cross(f.w, c_body)
    m = spec.mass[:, None]
    lin = (m * v_com).sum(0)
    com = (m * x_com).sum(0) / spec.mass.sum()
    I_w = jnp.einsum("nij,njk,nlk->nil", f.R, spec.inertia, f.R)
    ang = (
        jnp.einsum("nij,nj->ni", I_w, f.w) + jnp.cross(x_com - com, m * v_com)
    ).sum(0)
    return jnp.concatenate([lin, ang])


def centroidal_momentum_rate(
    spec: RobotSpec, q: jax.Array, v: jax.Array, a: jax.Array
) -> jax.Array:
    """d/dt h(q, v) along (v, a) via one jvp — the A(q)a + Adot(q,v)v term of
    the centroidal dynamics (CasADi's role in the reference formulation)."""
    _, hdot = jax.jvp(lambda qq, vv: centroidal_momentum(spec, qq, vv), (q, v), (v, a))
    return hdot


def contact_wrench_about_com(
    spec: RobotSpec, q: jax.Array, f_feet: jax.Array, gravity: float = GRAVITY
) -> jax.Array:
    """RHS of the centroidal dynamics: [sum f + m g, sum (p_i - c) x f_i]."""
    c = com_position(spec, q)
    p_feet = foot_positions(spec, q)
    lin = f_feet.sum(0) + spec.mass.sum() * jnp.array([0.0, 0.0, -gravity], dtype=q.dtype)
    ang = jnp.cross(p_feet - c, f_feet).sum(0)
    return jnp.concatenate([lin, ang])


def forward_dynamics(
    spec: RobotSpec,
    q: jax.Array,
    v: jax.Array,
    tau_joints: jax.Array,
    f_ext_feet: Optional[jax.Array] = None,
) -> jax.Array:
    """a = M^{-1} (S tau + J^T f - nle). Used by the on-device simulator."""
    tau_full = jnp.concatenate([jnp.zeros(6, dtype=q.dtype), tau_joints])
    rhs = tau_full - rnea(spec, q, v, jnp.zeros_like(v), f_ext_feet=f_ext_feet)
    M = mass_matrix(spec, q)
    L = jnp.linalg.cholesky(M)
    y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
