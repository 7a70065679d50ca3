"""Cold-boot warm starts for the NMPC solver: phase-aligned boot + the
learned-policy variants.

The BASELINE.json north star asks for "learned-policy warm-starts [to] feed
back into the solver to cut iterations". Two rounds of measurement
(scripts/bench_warmstart.py, tests/test_policy_warmstart.py) landed on a sharper
statement of where the win actually is:

- The engineered stationary `TrajOptSolver.cold_start` is already a
  3-iteration-quality initial guess; no policy-rollout (X, U) beats it at
  any iteration budget (numbers in `phase_aligned_warmstart`).
- What a cold boot is actually FREE to choose — and what moves the
  converged solution by up to 24% on perturbed states — is the GAIT-PHASE
  OFFSET of the contact schedule. `merit_phase_boot` picks it with one
  vmapped 3-iteration probe over all planner offsets and is exact on every
  tested state; it is the production cold-boot/divergence-recovery path of
  `mpc.controller.LocomotionMPC` (phase_aligned_boot=True).

Fully on device and jit/vmap-friendly: `apply_fn` is any (47,) -> (12,)
policy (e.g. `learning.network.make_policy_apply`).
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..models import dynamics as dyn
from ..ocp.problem import OCPParams
from ..robots.spec import RobotSpec


from ..learning.obs import policy_input as _obs_policy_input


def _policy_input(spec, q, v, v_des):
    return _obs_policy_input(spec, q, v, v_des)


def policy_warmstart(
    solver,
    apply_fn: Callable,
    params: OCPParams,
    v_des,
    kp: float = 20.0,
    kd: float = 1.5,
    sim_dt: float = 1.0e-3,
) -> Tuple[jax.Array, jax.Array]:
    """Device-plant policy rollout over the horizon -> (X, U) warm start.

    The policy's PD targets drive the soft-contact device simulator
    (sim/jax_sim) for the N-node horizon — one policy inference per node,
    PD at the control rate over the interval — and the node-boundary
    states, finite-difference accelerations, and contact-model forces form
    the initial guess. The rollout IS a feasible trajectory of a nearby
    plant, so defects start near zero and the GN steps go into optimality
    rather than feasibility.

    DESIGN NOTE (measured): a purely kinematic integration of the policy
    targets (first-order joint tracking + commanded-velocity base) was
    tried first and is strictly worse than the stationary cold start
    (13-14 vs 6-7 iterations-to-tol on the trot states) because the guess
    is dynamically inconsistent — and without saturation the open-loop MLP
    drifts out of distribution and NaNs the solve. The plant rollout costs
    ~N policy inferences + N*40 sim steps (one fused scan on device) and
    turns the warm start into a real iteration cut (see
    tests/test_policy_warmstart.py).
    """
    from ..sim import jax_sim

    spec: RobotSpec = solver.spec
    N = solver.N
    dt = solver.dt_nodes
    steps = max(1, int(round(dt / sim_dt)))
    x0 = params.x0
    v_des = jnp.asarray(v_des, x0.dtype)
    jl = jnp.asarray(spec.joint_limits, x0.dtype)
    tl = jnp.asarray(spec.torque_limit, x0.dtype)
    cp = jax_sim.contact_params_for(spec)

    def node(st, k):
        target = apply_fn(_policy_input(spec, st.q, st.v, v_des))
        target = jnp.clip(target, jl[:, 0], jl[:, 1])

        def ctrl(s, _):
            tau = jnp.clip(kp * (target - s.q[6:]) - kd * s.v[6:], -tl, tl)
            return jax_sim.step(spec, s, tau, cp, sim_dt), None

        st2, _ = jax.lax.scan(ctrl, st, None, length=steps)
        f = jax_sim.contact_forces(spec, st2.q, st2.v, cp)
        return st2, (st2.q, st2.v, f)

    st0 = jax_sim.SimState(x0[:18], x0[18:], jnp.asarray(0.0, x0.dtype))
    _, (Qs, Vs, Fs) = jax.lax.scan(node, st0, jnp.arange(N))
    X = jnp.concatenate(
        [x0[None], jnp.concatenate([Qs, Vs], axis=1)], axis=0
    )
    V_all = X[:, 18:]
    A_u = (V_all[1:] - V_all[:-1]) / dt
    # plan-consistent forces: contact-model forces where the PLAN says
    # stance (masking, never branching), zero on planned swing nodes
    f = Fs * params.cnt[:, :-1].T[:, :, None]
    U = jnp.concatenate([A_u, f.reshape(N, 12)], axis=1)
    return X, U


# ---------------------------------------------------------------------------
def contact_windows(planner, N: int):
    """(C, 4, N+1) contact windows at every gait-phase offset — one row per
    planner start node over a cycle. Host-side table for
    `phase_aligned_warmstart`; build once per (gait, solver) pair."""
    import numpy as np

    C = planner.nodes_per_cycle
    return np.stack([planner.get_contacts(o, N + 1) for o in range(C)]
                    ).astype(np.float32)


def merit_phase_boot(
    solver,
    params: OCPParams,
    windows,
    probe_iters: int = 3,
) -> Tuple[OCPParams, jax.Array, jax.Array]:
    """Pick the gait-phase offset that best fits the CURRENT state by
    batch-evaluating every planner offset: one vmapped (cold_start +
    `probe_iters`-iteration GN solve) per contact window, argmin merit.

    At a cold boot (first solve, post-divergence recovery) the planner
    phase is a free variable — nothing has been promised to the plant yet —
    and it matters: measured on the trot states of
    tests/test_policy_warmstart.py, the converged cost across the 12
    offsets spans 688..904 on a perturbed mid-gait state and 5682..9909 on
    a post-divergence recovery state. A 3-iteration probe ranks the TRUE
    best offset on every tested state (see the module bench,
    scripts/bench_warmstart.py), and the probe is one vmapped device call —
    on the batch-parallel solver, C=12 extra problems cost ~one batched
    solve.

    Returns (params', offset, probe_costs) where params' carries the
    selected cnt/peak windows; the caller aligns its node clock with
    `LocomotionMPC.resync_phase(offset)`. jit-able end to end.
    """
    import dataclasses as _dc

    windows = jnp.asarray(windows, params.x0.dtype)

    def one(w):
        p2 = _dc.replace(params, cnt=w, peak=1.0 - w)
        X, U = solver.cold_start(p2)
        return solver.solve(X, U, p2, probe_iters).stats.cost

    costs = jax.vmap(one)(windows)
    off = jnp.argmin(costs)
    w = windows[off]
    return _dc.replace(params, cnt=w, peak=1.0 - w), off, costs


def phase_aligned_warmstart(
    solver,
    apply_fn: Callable,
    params: OCPParams,
    v_des,
    windows,
    kp: float = 20.0,
    kd: float = 1.5,
    sim_dt: float = 1.0e-3,
    f_contact_thresh: float = 5.0,
):
    """Policy warm start with the planner phase chosen to MATCH the
    policy's emergent gait: free-run the policy in the device plant once,
    read its realized per-node foot-contact pattern from the contact-model
    normal forces, and pick the gait-phase offset whose contact window
    agrees most (Hamming score over all nodes x feet). Returns
    (X, U, params', offset) with params' carrying the matched cnt/peak.

    MEASURED VERDICT (round 5, closing the round-4 phase-mismatch
    diagnosis; regenerate with scripts/bench_warmstart.py):
    - The rollout (X, U) guess itself is strictly WORSE than the
      engineered stationary `cold_start` at every iteration budget
      (midgait cost after 1/3/6 iters: 1.2e6/5.1e4/880 vs 1.3e4/841/841) —
      soft-contact plant trajectories carry contact-pinning residuals the
      GN steps must polish away. Dissection: X-from-rollout alone costs
      +4-8 iterations; U-from-rollout alone lands in a worse basin on the
      recovery state.
    - The contact-pattern phase PICK is unreliable: the policy's emergent
      gait has its own duty cycle and period, so its contact pattern does
      not align with any planner window (picks offset 1 vs true best 10 on
      mid-gait, 0 vs 4 on recovery).
    Production cold boots therefore use `merit_phase_boot` (above), which
    finds the true best offset on every tested state for the price of one
    vmapped probe. This function remains the measured learned-policy
    alternative (BASELINE.json north-star accounting).

    Fully jit-able: `windows` is a static-shape (C, 4, N+1) table, the
    offset pick is an argmax, the window select a gather.
    """
    import dataclasses as _dc

    from ..sim import jax_sim

    spec: RobotSpec = solver.spec
    N = solver.N
    dt = solver.dt_nodes
    steps = max(1, int(round(dt / sim_dt)))
    x0 = params.x0
    v_des = jnp.asarray(v_des, x0.dtype)
    jl = jnp.asarray(spec.joint_limits, x0.dtype)
    tl = jnp.asarray(spec.torque_limit, x0.dtype)
    cp = jax_sim.contact_params_for(spec)
    windows = jnp.asarray(windows, x0.dtype)

    def node(st, k):
        target = apply_fn(_policy_input(spec, st.q, st.v, v_des))
        target = jnp.clip(target, jl[:, 0], jl[:, 1])

        def ctrl(s, _):
            tau = jnp.clip(kp * (target - s.q[6:]) - kd * s.v[6:], -tl, tl)
            return jax_sim.step(spec, s, tau, cp, sim_dt), None

        st2, _ = jax.lax.scan(ctrl, st, None, length=steps)
        f = jax_sim.contact_forces(spec, st2.q, st2.v, cp)
        return st2, (st2.q, st2.v, f)

    st0 = jax_sim.SimState(x0[:18], x0[18:], jnp.asarray(0.0, x0.dtype))
    _, (Qs, Vs, Fs) = jax.lax.scan(node, st0, jnp.arange(N))

    # realized contact flags at node boundaries 1..N (stance = normal force
    # above threshold); node 0 is x0 itself — skip it in the score
    flags = (Fs[:, :, 2] > f_contact_thresh).astype(x0.dtype)     # (N, 4)
    # windows[o][:, 1:N+1] is the scheduled contact state at those same
    # boundaries; Hamming agreement, uniform over nodes and feet
    sched = windows[:, :, 1: N + 1]                               # (C, 4, N)
    score = jnp.sum(sched * flags.T[None] + (1 - sched) * (1 - flags.T[None]),
                    axis=(1, 2))
    offset = jnp.argmax(score)
    cnt_sel = windows[offset]                                     # (4, N+1)

    X = jnp.concatenate(
        [x0[None], jnp.concatenate([Qs, Vs], axis=1)], axis=0
    )
    V_all = X[:, 18:]
    A_u = (V_all[1:] - V_all[:-1]) / dt
    f = Fs * cnt_sel[:, :-1].T[:, :, None]
    U = jnp.concatenate([A_u, f.reshape(N, 12)], axis=1)
    params2 = _dc.replace(params, cnt=cnt_sel, peak=1.0 - cnt_sel)
    return X, U, params2, offset
