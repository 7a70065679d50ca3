"""Batched on-device soft-contact quadruped simulator (pure JAX).

The device-side counterpart of the CPU MuJoCo plant (SURVEY.md §7.5): thousands
of rollouts per control step, vmapped/sharded over a device mesh. Used for
large-scale policy evaluation and datagen augmentation; CPU MuJoCo remains
the cross-check oracle (tests pin the two against each other on contact-free
and standing scenarios).

Contact model: compliant sphere-plane contact at the 4 feet — spring-damper
normal force + regularized Coulomb friction (smooth, differentiable; shapes
static). Integration: semi-implicit Euler at the control rate.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..models import dynamics as dyn
from ..robots.spec import RobotSpec


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ContactParams:
    stiffness: jax.Array      # N/m
    damping: jax.Array        # N s/m
    friction_mu: jax.Array
    vel_smoothing: jax.Array  # m/s tangential regularization


def default_contact_params(dtype=jnp.float32) -> ContactParams:
    # Tuned for stability under explicit integration at dt=1e-3: the
    # regularized Coulomb term acts as a tangential damper with coefficient
    # mu*fz/vel_smoothing — keep it below ~2*m_eff/dt or the feet chatter.
    # These values assume a Go2-class (~15 kg) robot; use
    # contact_params_for(spec) to mass-scale for lighter robots (Solo12's
    # ~0.05 kg feet make c/m_eff * dt > 2 here — explicit-damping unstable).
    return ContactParams(
        stiffness=jnp.asarray(2.0e4, dtype),
        damping=jnp.asarray(5.0e2, dtype),
        friction_mu=jnp.asarray(0.8, dtype),
        vel_smoothing=jnp.asarray(0.2, dtype),
    )


_GO2_TOTAL_MASS = 15.02   # the mass the default params were tuned at


def contact_params_for(spec: RobotSpec, dtype=jnp.float32) -> ContactParams:
    """Mass-scaled contact parameters: penetration depth and the explicit
    stability margins (omega*dt, c*dt/m_eff) are mass-ratio invariant when
    stiffness and damping scale with the robot's total mass."""
    import numpy as _np

    scale = float(_np.asarray(spec.mass).sum()) / _GO2_TOTAL_MASS
    base = default_contact_params(dtype)
    return ContactParams(
        stiffness=base.stiffness * scale,
        damping=base.damping * scale,
        friction_mu=base.friction_mu,
        vel_smoothing=base.vel_smoothing,
    )


class SimState(NamedTuple):
    q: jax.Array   # (18,) Euler chart
    v: jax.Array   # (18,)
    t: jax.Array   # ()


def contact_forces(spec: RobotSpec, q, v, cp: ContactParams,
                   ground_height: float = 0.0) -> jax.Array:
    """(4, 3) world contact forces at the feet."""
    p = dyn.foot_positions(spec, q)           # (4, 3) foot centers
    vel = dyn.foot_velocities(spec, q, v)
    r = spec.foot_radius
    depth = (ground_height + r) - p[:, 2]     # >0 when penetrating
    active = depth > 0.0
    fz = jnp.where(
        active,
        cp.stiffness * depth - cp.damping * vel[:, 2],
        0.0,
    )
    fz = jnp.maximum(fz, 0.0)
    vt = vel[:, :2]
    vt_norm = jnp.sqrt(jnp.sum(vt * vt, axis=1) + cp.vel_smoothing**2)
    ft = -cp.friction_mu * fz[:, None] * vt / vt_norm[:, None]
    return jnp.concatenate([ft, fz[:, None]], axis=1)


def step(spec: RobotSpec, state: SimState, tau_joints, cp: ContactParams,
         dt: float = 1.0e-3, f_ext: Optional[jax.Array] = None,
         substeps: int = 2, ground_height: float = 0.0) -> SimState:
    """One control step with `substeps` semi-implicit physics sub-steps.

    Penalty contact at quadruped stiffness needs a smaller integration step
    than the 1 kHz control rate to stay chatter-free; torques are held (ZOH)
    across the sub-steps.
    """
    tau = jnp.clip(tau_joints, -spec.torque_limit, spec.torque_limit)
    h = dt / substeps

    def sub(state, _):
        f_c = contact_forces(spec, state.q, state.v, cp, ground_height)
        a = dyn.forward_dynamics(spec, state.q, state.v, tau, f_ext_feet=f_c)
        if f_ext is not None:
            # world-frame force on the base maps onto the chart's prismatic
            # coordinates (small-perturbation fault injection)
            a = a.at[:3].add(f_ext[:3] / spec.mass.sum())
        v2 = state.v + h * a
        q2 = state.q + h * v2
        return SimState(q2, v2, state.t + h), None

    out, _ = jax.lax.scan(sub, state, None, length=substeps)
    return out


def pd_rollout(
    spec: RobotSpec,
    q0, v0,
    pd_targets,                      # (T, 12) joint PD targets
    kp: float = 20.0,
    kd: float = 1.5,
    dt: float = 1.0e-3,
    cp: Optional[ContactParams] = None,
    force_schedule=None,             # optional (T, 3) base force
):
    """Roll T steps under joint-PD toward given targets. Returns (Q, V)."""
    cp = cp or contact_params_for(spec, q0.dtype)

    def body(state, inp):
        target, f_ext = inp
        tau = kp * (target - state.q[6:]) - kd * state.v[6:]
        new = step(spec, state, tau, cp, dt, f_ext=f_ext)
        return new, (new.q, new.v)

    T = pd_targets.shape[0]
    f_sched = (
        force_schedule
        if force_schedule is not None
        else jnp.zeros((T, 3), q0.dtype)
    )
    init = SimState(q0, v0, jnp.asarray(0.0, q0.dtype))
    _, (Q, V) = jax.lax.scan(body, init, (pd_targets, f_sched))
    return Q, V


def make_batched_policy_rollout(
    spec: RobotSpec,
    apply_fn: Callable,              # (x (47,)) -> (12,) normalized policy
    T: int,
    kp: float = 20.0,
    kd: float = 1.5,
    dt: float = 1.0e-3,
):
    """Fully on-device batched policy rollout: vmap over environments.

    apply_fn gets the 44+3 policy input assembled on device (phase fixed 0,
    matching the reference's disabled-phase deployment) and returns joint
    PD targets. Returns a jitted fn (q0_batch, v0_batch, v_des_batch, key)
    -> (Q (B,T,18), V (B,T,18), fell (B,)).
    """
    cp = contact_params_for(spec)

    from ..learning.obs import policy_input

    def one_env(q0, v0, v_des):
        def body(state, _):
            x = policy_input(spec, state.q, state.v, v_des)
            target = apply_fn(x)
            tau = kp * (target - state.q[6:]) - kd * state.v[6:]
            new = step(spec, state, tau, cp, dt)
            return new, (new.q, new.v)

        init = SimState(q0, v0, jnp.asarray(0.0, q0.dtype))
        _, (Q, V) = jax.lax.scan(body, init, None, length=T)
        fell = jnp.any(Q[:, 2] < 0.15) | jnp.any(jnp.abs(Q[:, 4:6]) > 0.6)
        return Q, V, fell

    return jax.jit(jax.vmap(one_env))
