"""Fully on-device closed-loop MPC rollouts (batched expert datagen).

The reference generates BC data one CPU rollout at a time (MuJoCo + acados,
`Behavior_Cloning/utils/Rollout_MPC.py`). Here the ENTIRE closed loop —
RTI replan, plan interpolation, feed-forward RNEA + PD, soft-contact plant
step, dataset-row assembly — runs inside one jitted `lax.scan`, vmapped over
thousands of perturbed initial states and sharded over the device mesh.
This is the pod-scale datagen path from BASELINE.json: "thousands of
perturbed initial states and disturbance seeds rolled out in parallel per
control step".

Structure per environment:
  outer scan over replanning intervals (one OCP node = one 40 ms interval):
    - assemble OCP params from the device-resident gait tables + integrated
      velocity-tracking base reference,
    - warm-start shift by one node (+ AL dual shift), 1-iteration RTI solve,
    - Hermite-interpolate the first interval of the plan to the control rate
      and precompute feed-forward torques,
    - inner scan over the control steps: tau_ff + joint PD, soft-contact
      plant step, record the 44-dim dataset state + PD-target action.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..gait.planner import ContactPlanner
from ..models import dynamics as dyn
from ..mpc.config import get_quadruped_config
from ..mpc.interpolate import hermite_interp
from ..ocp.problem import OCPParams
from ..robots.spec import RobotSpec
from ..sim import jax_sim
from ..solver.sqp import TrajOptSolver


class RolloutBatch(NamedTuple):
    """Per-env, per-step dataset rows (B, T, ...)."""

    q: jax.Array          # (B, T, 18) chart positions
    v: jax.Array          # (B, T, 18)
    state44: jax.Array    # (B, T, 44) policy-state rows
    action: jax.Array     # (B, T, 12) PD-target actions
    tau: jax.Array        # (B, T, 12) applied torques
    valid: jax.Array      # (B, T) 1 until the env fell
    is_expert: jax.Array  # (B, T) 1 where the MPC expert was in control
                          # (all ones for plain expert rollouts; the
                          # SafeDAgger data step keeps only these rows)


from .obs import policy_state as _dataset_state  # single source of truth


def make_batched_mpc_rollout(
    spec: RobotSpec,
    gait_name: str = "trot",
    n_intervals: int = 50,          # replanning intervals (1 node each)
    sim_dt: float = 1.0e-3,
    kd_action: float = 1.5,         # dataset action encoding kd (recorder)
    contact_params: Optional[jax_sim.ContactParams] = None,
    policy=None,                    # (net, variables, norm) -> SafeDAgger mode
    policy_kp: float = 20.0,
    policy_kd: float = 1.5,
    delay_steps: int = 100,
    mpc_min_steps: int = 2500,
    unsafe_height_bounds=None,      # override safety.UNSAFE_HEIGHT_BOUNDS
    vel_track_tol: Optional[float] = None,
):
    """Build the jitted batched closed-loop rollout.

    Returns fn(x0 (B, 36), v_des (B, 3), key) -> RolloutBatch with
    T = n_intervals * steps_per_interval control steps.

    With `policy` given (a `(net, variables, norm)` triple as returned by
    `network.load_policy`), the rollout becomes the fully ON-DEVICE
    SafeDAgger combined controller (the host version lives in
    `learning/combined_controller.py`, reference
    `DAgger/utils/Rollout_combined_controller.py:271-508`): the learned
    policy and the MPC expert both act every control step — the expert's
    plan stays warm by construction since the RTI solve runs every interval
    regardless of who is in control — a jnp port of `check_unsafe_state_v2`
    plus the reference's hysteresis (policy-only for the first
    `delay_steps`, MPC latched >= `mpc_min_steps` once engaged) selects the
    applied torque, and every dataset row carries `is_expert` for the
    DAgger expert-row filter (`data_collection_locosafedagger.py:179-206`).
    This makes the entire DAgger data step batched on the device.
    """
    gait, opt, cost = get_quadruped_config(gait_name, spec.name)
    solver = TrajOptSolver(spec, opt, cost)
    N = solver.N
    dt_nodes = solver.dt_nodes
    steps = int(round(dt_nodes / sim_dt))       # control steps per interval
    planner = ContactPlanner(spec.feet_frame_names, dt_nodes, gait)
    cycle = planner.nodes_per_cycle
    # device gait table: contacts/peaks window per start-node-in-cycle
    cnt_table = np.stack(
        [planner.get_contacts(k, N + 1) for k in range(cycle)]
    ).astype(np.float32)                        # (cycle, 4, N+1)
    peak_table = 1.0 - cnt_table
    ground = float(np.asarray(spec.foot_radius))
    plane = np.zeros((4, N + 1, 3), np.float32)
    plane[:, :, 2] = ground
    joint_ref = np.asarray(spec.q_home)[6:].astype(np.float32)
    cp = contact_params or jax_sim.contact_params_for(spec)
    Kp, Kd = opt.Kp, opt.Kd
    nom_h = gait.nom_height + ground
    step_h = gait.step_height + ground
    tl = np.asarray(spec.torque_limit)

    cnt_table_dev = jnp.asarray(cnt_table)
    peak_table_dev = jnp.asarray(peak_table)

    # --- on-device safety monitor + policy forward (SafeDAgger mode) ---
    from .safety import (
        JOINT_BOUNDS_FLAT,
        UNSAFE_HEIGHT_BOUNDS,
        UNSAFE_MAX_ROLL_PITCH_DEG,
        VEL_TRACK_TOL,
    )

    jb_rad = np.deg2rad(np.asarray(JOINT_BOUNDS_FLAT)).astype(np.float32)
    max_rp = float(np.deg2rad(UNSAFE_MAX_ROLL_PITCH_DEG))
    # tighter-than-default bands let DAgger collects trigger the expert on
    # height DRIFT (the measured 0.3 m/s sim-to-real failure mode: slow
    # z collapse 0.29 -> 0.20 over ~0.6 s, docs/TRANSFER.md) so relabeled
    # recovery data covers the drift manifold before the fall
    lo_h, hi_h = unsafe_height_bounds or UNSAFE_HEIGHT_BOUNDS
    v_tol = vel_track_tol if vel_track_tol is not None else VEL_TRACK_TOL

    def unsafe_v2_dev(q, v, v_des):
        """jnp port of combined_controller.check_unsafe_state_v2 (chart
        coordinates: q[3:6] = [yaw, pitch, roll])."""
        pose = (
            (jnp.abs(q[5]) > max_rp)
            | (jnp.abs(q[4]) > max_rp)
            | (q[2] < lo_h)
            | (q[2] > hi_h)
        )
        joints = jnp.any(
            (q[6:] < jb_rad[:, 0]) | (q[6:] > jb_rad[:, 1]))
        track = jnp.any(jnp.abs(v[:2] - v_des[:2]) > v_tol)
        return pose | joints | track

    def _norm_arrays(norm):
        """(mu_s, sigma_s, mu_g, sigma_g) -> guarded f32 arrays (jnp: must
        also work on tracers — `fn` is jitted and norm stats are traced)."""
        f32 = jnp.float32
        s_std = jnp.asarray(norm[1], f32)
        g_std = jnp.asarray(norm[3], f32)
        return (jnp.asarray(norm[0], f32),
                jnp.where(s_std > 1e-8, s_std, 1.0),
                jnp.asarray(norm[2], f32),
                jnp.where(g_std > 1e-8, g_std, 1.0))

    if policy is not None:
        pol_net, pol_vars, pol_norm = policy
        has_norm = pol_norm is not None

        # The policy runs per env under jax.vmap: the env axis is the
        # matmul batch, so XLA batches the (B,47)x(47,512) chain directly.
        def policy_tau(pstate, state44, q, v, v_des):
            pvars, nrm = pstate
            s = state44
            g = v_des
            if has_norm:
                s_mean, s_std, g_mean, g_std = nrm
                s = s.at[1:].set((s[1:] - s_mean[1:]) / s_std[1:])
                g = (g - g_mean) / g_std
            x_in = jnp.concatenate([s, g])
            a = pol_net.apply(pvars, x_in[None], train=False)[0]
            return policy_kp * (a - q[6:]) - policy_kd * v[6:]

    def params_for(node_i, x, ref_xy_yaw, v_des):
        cnt = cnt_table_dev[jnp.mod(node_i, cycle)]
        peak = peak_table_dev[jnp.mod(node_i, cycle)]
        # velocity-tracking base reference (device port of mpc.py:210-272):
        # terminal ref = integrated goal position + v_des*horizon; the RUNNING
        # position ref starts at the CURRENT base and leads 75% of the way to
        # the terminal (mpc.py:262-263) — the lead is what produces the
        # reference's fast velocity ramp-up.
        ref_e_xy = ref_xy_yaw[:2] + v_des[:2] * opt.time_horizon
        run_xy = x[:2] + (ref_e_xy - x[:2]) * 0.75
        base_ref = jnp.zeros(12, x.dtype)
        base_ref = base_ref.at[0].set(run_xy[0])
        base_ref = base_ref.at[1].set(run_xy[1])
        base_ref = base_ref.at[2].set(nom_h)
        base_ref = base_ref.at[3].set(ref_xy_yaw[2])
        base_ref = base_ref.at[6:9].set(v_des)
        base_ref_e = base_ref.at[:2].set(ref_e_xy)
        return OCPParams(
            x0=x,
            cnt=jnp.asarray(cnt),
            peak=jnp.asarray(peak),
            plane_point=jnp.asarray(plane),
            cnt_loc=jnp.zeros((4, N + 1, 3), x.dtype),
            patch_radius=jnp.full((4, N + 1), 1.0e3, x.dtype),
            restrict=jnp.asarray(0.0, x.dtype),
            base_ref=base_ref,
            base_ref_e=base_ref_e,
            joint_ref=jnp.asarray(joint_ref),
            step_height=jnp.asarray(step_h, x.dtype),
            dt=jnp.full((N,), dt_nodes, x.dtype),
            lam_eq=jnp.zeros((N, 18), x.dtype),
            lam_ineq=jnp.zeros((N, 36), x.dtype),
        )

    def one_env(x0, v_des, plant_spec, terrain, pstate, force_win):
        """plant_spec / terrain carry per-env domain randomization (payload,
        ground height, contact params); the CONTROLLER model stays nominal —
        model-plant mismatch is the realistic robustness setting. `pstate`
        is (policy weights, norm stats) as a TRACED argument so DAgger
        iterations reuse the compiled rollout with fresh weights (unused
        when the rollout has no policy)."""
        # initial converged plan (cold start, a few SQP iterations)
        p0 = params_for(0, x0, jnp.concatenate([x0[:2], x0[3:4]]), v_des)
        Xw, Uw = solver.cold_start(p0)
        sol0 = solver.solve(Xw, Uw, p0, 6)

        def interval(carry, i):
            x, X_prev, U_prev, lam, lami, ref, alive, mode, mpc_cnt, stepc = carry
            p = params_for(i, x, ref, v_des)
            p = dataclasses.replace(
                p,
                lam_eq=solver.shift_multipliers(lam, 1),
                lam_ineq=solver.shift_multipliers(lami, 1),
            )
            X_ws, U_ws = solver.shift_warmstart(X_prev, U_prev, 1)
            X_ws = X_ws.at[0].set(x)
            sol = solver.solve(X_ws, U_ws, p, 1)
            lam_new = solver.update_multipliers(sol.X, sol.U, p,
                                                r_eq=sol.r_eq)

            # interpolate the first interval of the plan to the control rate
            t_knots = jnp.concatenate([jnp.zeros(1, x.dtype), jnp.cumsum(p.dt)])
            t_q = (jnp.arange(steps, dtype=x.dtype) + 1.0) * sim_dt
            q_plan = hermite_interp(t_knots, sol.q, sol.v, t_q)
            a0 = sol.a[:1]
            v_plan = hermite_interp(
                t_knots, sol.v, jnp.concatenate([a0, sol.a]), t_q
            )
            a_plan = jnp.tile(sol.a[0][None], (steps, 1))
            f_plan = jnp.tile(sol.f[0][None], (steps, 1, 1))
            tau_ff = jax.vmap(partial(dyn.id_torques, spec))(
                q_plan, v_plan, a_plan, f_plan
            )

            def ctrl_step(sx, inp):
                q_d, v_d, ff = inp
                st, mode_mpc, mpc_cnt, stepc = sx
                tau_mpc = (
                    ff
                    + Kp * (q_d[6:] - st.q[6:])
                    + Kd * (v_d[6:] - st.v[6:])
                )
                tau_mpc = jnp.clip(tau_mpc, -tl, tl)
                # record (s_t, a_t) BEFORE stepping — same alignment as the
                # host recorder (record() runs before mj_step)
                state44 = _dataset_state(spec, st.q, st.v)
                if policy is not None:
                    # SafeDAgger: both controllers act; hysteresis switch
                    # (reference Rollout_combined_controller.py:449-499)
                    tau_pol = jnp.clip(
                        policy_tau(pstate, state44, st.q, st.v, v_des),
                        -tl, tl)
                    unsafe = unsafe_v2_dev(st.q, st.v, v_des)
                    in_delay = stepc < delay_steps
                    leave_mpc = (mpc_cnt + 1 >= mpc_min_steps) & ~unsafe
                    mode_new = jnp.where(mode_mpc, ~leave_mpc,
                                         unsafe & ~in_delay)
                    mpc_cnt = jnp.where(mode_new,
                                        jnp.where(mode_mpc, mpc_cnt + 1, 0),
                                        0)
                    tau = jnp.where(mode_new, tau_mpc, tau_pol)
                else:
                    mode_new = mode_mpc            # always-expert rollout
                    tau = tau_mpc
                action = (tau + kd_action * st.v[6:]) / Kp + st.q[6:]
                # scheduled base-wrench fault injection (the reference's
                # force-perturbation datagen, 50-70 N / 0.2-0.4 s windows —
                # data_collection_force_perturbation.py:213-248 — here fully
                # on-device): force_win = [start_step, end_step, fx, fy, fz]
                in_win = ((stepc >= force_win[0].astype(jnp.int32))
                          & (stepc < force_win[1].astype(jnp.int32)))
                f_ext = jnp.where(in_win, 1.0, 0.0) * force_win[2:5]
                new = jax_sim.step(
                    plant_spec, st, tau, terrain.contact, sim_dt,
                    f_ext=f_ext,
                    ground_height=terrain.ground_height,
                )
                rec = (st.q, st.v, state44, action, tau,
                       mode_new.astype(x.dtype))
                return (new, mode_new, mpc_cnt, stepc + 1), rec

            st0 = jax_sim.SimState(x[:18], x[18:], jnp.asarray(0.0, x.dtype))
            (st_end, mode, mpc_cnt, stepc), recs = jax.lax.scan(
                ctrl_step, (st0, mode, mpc_cnt, stepc),
                (q_plan, v_plan, tau_ff))
            x_new = jnp.concatenate([st_end.q, st_end.v])

            # fall detection: freeze 'alive' once violated (thresholds from
            # learning/safety.py — shared with the host safety monitor)
            from .safety import FALL_HEIGHT_BOUNDS, FALL_MAX_TILT_RAD

            upright = (
                (st_end.q[2] > FALL_HEIGHT_BOUNDS[0])
                & (st_end.q[2] < FALL_HEIGHT_BOUNDS[1])
                & (jnp.abs(st_end.q[4]) < FALL_MAX_TILT_RAD)
                & (jnp.abs(st_end.q[5]) < FALL_MAX_TILT_RAD)
            )
            alive_new = alive * upright.astype(x.dtype)
            ref_new = ref + jnp.concatenate([v_des[:2], jnp.zeros(1, x.dtype)]) * dt_nodes
            valid = jnp.full((steps,), alive_new, x.dtype)
            out = recs + (valid,)
            return (x_new, sol.X, sol.U, lam_new, sol.lam_ineq, ref_new,
                    alive_new, mode, mpc_cnt, stepc), out

        ref0 = jnp.concatenate([x0[:2], x0[3:4]])
        carry0 = (
            x0, sol0.X, sol0.U, jnp.zeros((N, 18), x0.dtype), sol0.lam_ineq,
            ref0, jnp.asarray(1.0, x0.dtype),
            # expert rollouts start (and stay) in MPC mode; SafeDAgger starts
            # with the policy in control (reference :449-456)
            jnp.asarray(policy is None), jnp.asarray(0), jnp.asarray(0),
        )
        _, (Q, V, S44, A, TAU, EXP, VALID) = jax.lax.scan(
            interval, carry0, jnp.arange(n_intervals)
        )
        # (n_intervals, steps, d) -> (T, d)
        flat = lambda z: z.reshape((-1,) + z.shape[2:])
        return RolloutBatch(
            q=flat(Q), v=flat(V), state44=flat(S44), action=flat(A),
            tau=flat(TAU), valid=VALID.reshape(-1),
            is_expert=EXP.reshape(-1),
        )

    from .randomize import TerrainParams, payload_spec_axes

    vmapped = jax.vmap(
        one_env,
        in_axes=(0, 0, payload_spec_axes(spec),
                 TerrainParams(0, jax_sim.ContactParams(0, 0, 0, 0)), None,
                 0),
    )

    def fn(x0, v_des, plant_spec=None, terrain=None, policy_update=None,
           force_windows=None):
        """x0 (B, 36), v_des (B, 3); optional per-env plant randomization:
        plant_spec from randomize.randomize_payload, terrain from
        randomize.randomize_terrain (defaults = nominal plant).
        `policy_update=(variables, (mu_s, sigma_s, mu_g, sigma_g))`
        overrides the policy weights + norm stats per call (same pytree
        structure, norm presence must match the build-time policy) without
        recompiling — the DAgger outer loop's retrained policies go
        through here. `force_windows` (B, 5) = per-env scheduled base
        wrench [start_step, end_step, fx, fy, fz] (fault injection; default
        none)."""
        B = x0.shape[0]
        if plant_spec is None:
            import dataclasses as _dc

            plant_spec = _dc.replace(
                spec,
                mass=jnp.broadcast_to(jnp.asarray(spec.mass)[None],
                                      (B,) + spec.mass.shape),
                com=jnp.broadcast_to(jnp.asarray(spec.com)[None],
                                     (B,) + spec.com.shape),
            )
        if terrain is None:
            terrain = TerrainParams(
                ground_height=jnp.zeros((B,), x0.dtype),
                contact=jax.tree.map(
                    lambda x: jnp.broadcast_to(jnp.asarray(x), (B,)), cp
                ),
            )
        if policy is None:
            pstate = jnp.zeros(())
        elif policy_update is None:
            pstate = (pol_vars,
                      _norm_arrays(pol_norm) if pol_norm is not None else ())
        else:
            pv, nrm = policy_update
            pstate = (pv, _norm_arrays(nrm) if nrm is not None else ())
        if force_windows is None:
            force_windows = jnp.zeros((B, 5), x0.dtype)  # empty window
        return vmapped(x0, v_des, plant_spec, terrain, pstate,
                       force_windows)

    return jax.jit(fn)
