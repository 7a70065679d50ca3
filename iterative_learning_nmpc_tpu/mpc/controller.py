"""Closed-loop locomotion MPC controller.

JAX re-design of the reference `LocomotionMPC` (`mpc_controller/mpc.py:19-694`):

- The *entire* replan — warm-start shift, GN-SQP solve, Hermite interpolation
  to the control rate, ZOH inputs, and feed-forward RNEA torques along the
  interpolated plan — is ONE jitted device call (`_plan`). The 1 kHz host loop
  then only does array lookups + joint PD (tiny numpy ops).
- Asynchronous replanning keeps the reference's structure: a 1-worker
  ThreadPoolExecutor runs the device call concurrently with sim stepping
  (`mpc.py:163-166,507-569`), with the same delay compensation
  `ceil(replan_time/sim_dt) - 1` (`mpc.py:548-555`).
- First solve runs `max_iter_first` SQP iterations, steady state runs
  `max_iter` (RTI) — two jit specializations, mirroring `mpc.py:464-473`.
"""
from __future__ import annotations

import math
import time
import traceback
from collections import defaultdict
from concurrent.futures import Future, ThreadPoolExecutor
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..gait.planner import ContactPlanner, CustomContactPlanner, RaibertContactPlanner
from ..models import dynamics as dyn
from ..models import transforms_np as tnp
from ..mpc.config import get_quadruped_config
from ..mpc.interpolate import interpolate_plan
from ..robots.spec import RobotSpec
from ..solver.sqp import TrajOptSolver, make_params
from ..utils.profiling import print_timings, time_fn


class LocomotionMPC:
    """Velocity-tracking whole-body MPC for a quadruped."""

    def __init__(
        self,
        spec: RobotSpec,
        gait_name: str = "trot",
        joint_ref: Optional[np.ndarray] = None,
        sim_dt: float = 1.0e-3,
        height_offset: float = 0.0,
        contact_planner: str = "",
        interactive_goal: bool = False,
        print_info: bool = False,
        compute_timings: bool = True,
        solve_async: bool = True,
        async_sim_latency: float = 0.02,
        phase_aligned_boot: bool = True,
        recover_on_divergence: int = 0,
        dtype=jnp.float32,
    ) -> None:
        """async_sim_latency: when the co-simulation does not run in real
        time, model the solver latency in SIM seconds — the plan becomes
        available `async_sim_latency` sim-seconds after submission and the
        delay compensation uses that figure. Set to None to use wall-clock
        latency like the reference (only meaningful for real-time runs).

        phase_aligned_boot: on a cold boot (first solve / divergence
        recovery) pick the gait-phase offset that best fits the current
        state — `solver.warmstart.merit_phase_boot`, one vmapped
        3-iteration probe over all planner offsets (measured: up to 24%
        better converged solutions on perturbed states at equal iteration
        count). Cyclic unrestricted planners only; a capability the
        reference lacks (it always boots at its node clock's phase,
        `mpc.py:317-369`).

        recover_on_divergence: number of automatic cold reboots after a
        solver failure (exception on the worker). 0 keeps the reference
        behavior — mark diverged and hold the last plan (`mpc.py:562-569`);
        n > 0 resets the warm-start state and re-enters through the
        phase-aligned cold boot, up to n times per reset()."""
        self.spec = spec
        self.gait_name = gait_name
        self.print_info = print_info
        self.height_offset = height_offset
        self.config_gait, self.config_opt, self.config_cost = get_quadruped_config(
            gait_name, spec.name
        )
        self.solver = TrajOptSolver(spec, self.config_opt, self.config_cost, dtype=dtype)

        self.nu = spec.nu
        self.nv = spec.nv
        self.n_foot = spec.n_foot
        self.joint_ref = (
            np.asarray(spec.q_home[6:], dtype=np.float64)
            if joint_ref is None
            else np.asarray(joint_ref, dtype=np.float64)[-self.nu:]
        )

        # Contact-plane height for the FOOT CENTER: the physical foot sphere
        # rests with its center one radius above the ground. Getting this
        # wrong makes the stance PD press into the floor and the base climb.
        self._ground = float(height_offset) + float(np.asarray(spec.foot_radius))

        # contact planner selection (mpc.py:78-105)
        self._contact_planner_str = contact_planner
        feet = spec.feet_frame_names
        dt_nodes = self.solver.dt_nodes
        if contact_planner.lower() == "raibert":
            q0 = np.asarray(spec.q_home, dtype=np.float64)
            hip_idx = [6 + 3 * i for i in range(4)]
            # hip xy offsets in base frame
            offset_hip_b = np.zeros((4, 3))
            offset_hip_b[:, :2] = np.asarray(spec.joint_pos)[hip_idx, :2]
            self.contact_planner = RaibertContactPlanner(
                feet, dt_nodes, self.config_gait, offset_hip_b,
                y_offset=0.02, x_offset=0.04, foot_size=0.0085, cache_cnt=False,
            )
            self.restrict_cnt = True
        elif contact_planner.lower() == "custom":
            self.contact_planner = CustomContactPlanner(feet, dt_nodes, self.config_gait)
            self.restrict_cnt = True
        else:
            self.contact_planner = ContactPlanner(feet, dt_nodes, self.config_gait)
            self.restrict_cnt = False

        # loop constants
        self.Kp = self.config_opt.Kp
        self.Kd = self.config_opt.Kd
        self.sim_dt = sim_dt
        self.dt_nodes: float = dt_nodes
        self.replanning_freq = self.config_opt.replanning_freq
        self.replanning_steps = int(1 / (self.replanning_freq * sim_dt))
        self.solve_async = solve_async
        self.async_sim_latency = async_sim_latency
        self.compute_timings = compute_timings
        self.interactive_goal = interactive_goal
        self.recover_on_divergence = recover_on_divergence
        self.n_interp_plan = round(self.config_opt.time_horizon / sim_dt)

        # phase-aligned cold boot: merit probe over the planner's contact
        # windows (cyclic unrestricted planners only — restricted modes pin
        # footstep locations to the node clock's phase)
        self.phase_aligned_boot = phase_aligned_boot and not self.restrict_cnt
        self._boot_jit = None
        if self.phase_aligned_boot:
            from ..solver.warmstart import contact_windows, merit_phase_boot

            windows = contact_windows(
                self.contact_planner, self.config_opt.n_nodes)
            self._boot_jit = jax.jit(
                lambda p: merit_phase_boot(self.solver, p, windows))

        self._build_plan_fn()
        self._com_jit = jax.jit(lambda q: dyn.com_position(spec, q))
        self.reset(reset_solver=False)

    # ------------------------------------------------------------------
    def _build_plan_fn(self):
        solver = self.solver
        n_interp = self.n_interp_plan
        spec = self.spec

        def plan(X_prev, U_prev, lam_prev, lami_prev, shift, params, n_iter):
            import dataclasses as _dc

            X_ws, U_ws = solver.shift_warmstart(X_prev, U_prev, shift)
            X_ws = X_ws.at[0].set(params.x0)
            # dual warm start: shift AL multipliers (equality + inequality)
            # with the primal — the reference's full dual warm start
            # (solver.py:290-342)
            lam_ws = solver.shift_multipliers(lam_prev, shift)
            lami_ws = solver.shift_multipliers(lami_prev, shift)
            params = _dc.replace(params, lam_eq=lam_ws, lam_ineq=lami_ws)
            sol = solver.solve(X_ws, U_ws, params, n_iter)
            lam_new = solver.update_multipliers(sol.X, sol.U, params,
                                                r_eq=sol.r_eq)
            q_plan, v_plan, id_rep = interpolate_plan(
                sol.q, sol.v, sol.a, sol.dt_sol(params.dt), n_interp
            )
            a_plan = sol.a[id_rep]
            f_plan = sol.f[id_rep]
            tau_ff = jax.vmap(partial(dyn.id_torques, spec))(q_plan, v_plan, a_plan, f_plan)
            return (sol.X, sol.U, lam_new, sol.lam_ineq, q_plan, v_plan,
                    a_plan, f_plan, tau_ff, sol.stats)

        # raw (unjitted) plan fn — the batched plant collector vmaps it
        # over an env axis (learning/plant_batch.py)
        self._plan_fn = plan
        self._plan_jit = jax.jit(plan, static_argnums=6)

    # ------------------------------------------------------------------
    def warmup(self, q: Optional[np.ndarray] = None,
               v: Optional[np.ndarray] = None) -> float:
        """Precompile both replan jit specializations (first-solve boost and
        RTI steady state) before entering the real-time loop, so no control
        step ever blocks on XLA compilation (a real-time deployment API the
        reference lacks — it blocks the 1 kHz loop on the first plan
        instead, `mpc.py:475-599`). Returns wall seconds spent.

        State is reset afterwards; the compiled executables stay cached, so
        the next first replan only pays the device solve time."""
        t0 = time.perf_counter()
        if q is None:
            q = np.asarray(self.spec.q_home, np.float64).copy()
            q[2] += self.height_offset
        if v is None:
            v = np.zeros(self.nv)
        self.optimize(q, v)       # first-solve specialization (max_iter_first)
        self.first_solve = False
        self.optimize(q, v)       # steady-state specialization (max_iter)
        self.reset(reset_solver=False)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    def reset(self, reset_solver: bool = True) -> None:
        self.first_solve = True
        self.diverged = False
        self.t0 = 0.0
        self.sim_step = 0
        self.plan_step = 0
        self.current_opt_node = 0
        self.last_node = 0
        self.delay = 0
        self._phase_time_offset = 0.0

        self.v_des = np.zeros(3)
        self.w_des = np.zeros(3)
        self.base_ref_vel_tracking = np.zeros(12)
        self._recoveries_left = self.recover_on_divergence
        self.boot_offsets = []  # phase offsets picked at cold boots

        self.q_plan = np.zeros((self.n_interp_plan, self.nv))
        self.v_plan = np.zeros((self.n_interp_plan, self.nv))
        self.a_plan = np.zeros((self.n_interp_plan, self.nv))
        self.f_plan = np.zeros((self.n_interp_plan, self.n_foot, 3))
        self.tau_ff_plan = np.zeros((self.n_interp_plan, self.nu))
        self.torques_dof = np.zeros(self.nv)

        self._X_prev = None
        self._U_prev = None
        self._lam_prev = None
        self._lami_prev = None

        # plots / records: realized trajectories + the time-aligned PLAN rows
        # consumed at each step (reference plan-vs-realized plotting,
        # `mpc.py:601-685`)
        self.q_full, self.v_full, self.a_full, self.f_full, self.tau_full = [], [], [], [], []
        self.q_plan_full, self.v_plan_full = [], []
        self.a_plan_full, self.f_plan_full = [], []
        self.tau_plan_full, self.dt_plan_full = [], []
        self._last_dt_sol = np.full(self.config_opt.n_nodes, self.dt_nodes)
        self._last_base_ref = np.zeros(12)
        self._last_base_ref_e = np.zeros(12)
        self._last_cnt_loc = None
        self.timings = defaultdict(list)

        if getattr(self, "executor", None) is not None:
            self.executor.shutdown(wait=False, cancel_futures=True)
        self.executor = ThreadPoolExecutor(max_workers=1)
        self.optimize_future: Future = Future()
        self.plan_submitted = False

        self.velocity_goal = None
        if self.interactive_goal:
            from ..utils.interactive import SetVelocityGoal

            self.velocity_goal = SetVelocityGoal()

    # ------------------------------------------------------------------
    def set_command(self, v_des: np.ndarray = np.zeros(3), w_yaw: float = 0.0) -> None:
        self.v_des = np.asarray(v_des, dtype=np.float64)
        self.w_des[2] = w_yaw

    def set_phase(self, start_time: float) -> None:
        """Align the gait phase with an absolute trajectory time — used by
        mid-trajectory restarts so the contact schedule continues from the
        nominal timeline (reference phase-percentage shift,
        `RolloutMPC_shift_phase_percentage.py`)."""
        self.current_opt_node = int(round(start_time / self.dt_nodes))
        self._phase_time_offset = self.current_opt_node * self.dt_nodes

    def increment_base_ref_position(self):
        """Integrate the velocity goal into the tracked base reference
        (mpc.py:204-208)."""
        R_WB = tnp.ypr_to_matrix(
            np.array([self.base_ref_vel_tracking[3], 0.0, 0.0])
        )
        # DEVIATION from mpc.py:206/228 (np.round(..., 1)): the reference's
        # 1-decimal rounding quantizes commands to 0.1 m/s — a 0.15 m/s
        # goal (the slow-gait operating point) becomes 0.2 and is
        # untrackable by construction. 2 decimals keeps the reference's
        # anti-jitter intent at 10x finer command resolution.
        v_des_glob = np.round(R_WB @ self.v_des, 2)
        self.base_ref_vel_tracking[:2] += v_des_glob[:2] * self.sim_dt
        self.base_ref_vel_tracking[3] += self.w_des[2] * self.sim_dt

    def compute_base_ref_vel_tracking(self, q: np.ndarray):
        """Velocity-tracking base reference (mpc.py:210-272)."""
        t_horizon = self.config_opt.time_horizon
        base_ref = np.zeros(12)
        base_ref[:2] = np.round(q[:2], 2)
        base_ref[2] = self.config_gait.nom_height + self.height_offset
        base_ref[3] = round(q[3], 1)

        R_WB = tnp.ypr_to_matrix(np.array([self.base_ref_vel_tracking[3], 0.0, 0.0]))
        # DEVIATION from mpc.py:206/228 (np.round(..., 1)): the reference's
        # 1-decimal rounding quantizes commands to 0.1 m/s — a 0.15 m/s
        # goal (the slow-gait operating point) becomes 0.2 and is
        # untrackable by construction. 2 decimals keeps the reference's
        # anti-jitter intent at 10x finer command resolution.
        v_des_glob = np.round(R_WB @ self.v_des, 2)
        base_ref[6:9] = v_des_glob
        # chart angular slots are [yaw, pitch, roll] rates; w_des is [wx, wy, wz]
        base_ref[9:12] = self.w_des[::-1]

        base_ref_e = base_ref.copy()
        R_yaw = tnp.ypr_to_matrix(np.array([self.w_des[2] * t_horizon, 0.0, 0.0]))
        base_ref_e[6:9] = R_yaw @ base_ref[6:9]

        if self.velocity_goal is not None:
            pos_ref = np.round(q[:3], 2)
            yaw_ref = q[3]
        else:
            pos_ref = self.base_ref_vel_tracking[:3]
            yaw_ref = self.base_ref_vel_tracking[3]

        base_ref_e[:2] = pos_ref[:2] + v_des_glob[:2] * t_horizon
        base_ref_e[3] = yaw_ref + self.w_des[2] * t_horizon
        # intermediate running ref (mpc.py:262-263)
        base_ref[:2] += (base_ref_e[:2] - base_ref[:2]) * 0.75
        base_ref[3] += (base_ref_e[3] - base_ref[3]) * 0.75
        # flatten roll/pitch and terminal vertical motion (mpc.py:265-270)
        base_ref_e[8] = 0.0
        base_ref_e[4:6] = 0.0
        base_ref[4:6] = 0.0
        base_ref_e[10:12] = 0.0
        return base_ref, base_ref_e

    def compute_base_ref_cnt_restricted(self, q: np.ndarray, cnt_loc: np.ndarray):
        """Base reference from a contact plan (mpc.py:274-315)."""
        nonzero = np.all(cnt_loc != 0.0, axis=-1)  # (4, n_nodes)
        first_ids = np.argwhere(nonzero.all(axis=0))
        base_ref = np.zeros(12)
        base_ref_e = np.zeros(12)
        if len(first_ids) > 0:
            i0, i1 = int(first_ids[0]), int(first_ids[-1])
            center_first = cnt_loc[:, i0, :].mean(axis=0)
            center_last = cnt_loc[:, i1, :].mean(axis=0)
        else:
            center_first = cnt_loc[:, 0, :].mean(axis=0)
            center_last = cnt_loc[:, -1, :].mean(axis=0)
        alpha = 0.35
        base_ref[:2] = alpha * center_first[:2] + (1 - alpha) * center_last[:2]
        base_ref_e[:2] = center_last[:2]
        base_ref[2] = self.config_gait.nom_height + self.height_offset
        base_ref_e[2] = base_ref[2]
        return base_ref, base_ref_e

    # ------------------------------------------------------------------
    @time_fn("optimize")
    def optimize(self, q: np.ndarray, v: np.ndarray):
        """One full replan: assemble parameters, solve, interpolate.

        Runs on the worker thread; everything heavy is inside the jitted
        `_plan` (device).
        """
        node = self.current_opt_node
        N = self.config_opt.n_nodes

        if self.velocity_goal is not None:
            self.v_des, self.w_des[2] = self.velocity_goal.get_velocity()

        cnt = self.contact_planner.get_contacts(node, N + 1).astype(np.float32)
        peak = (
            self.contact_planner.get_peaks(node, N + 1).astype(np.float32)
            if self.config_opt.opt_peak
            else 1.0 - cnt
        )
        cnt_loc = None
        if self.restrict_cnt:
            if self._contact_planner_str.lower() == "raibert":
                com_xyz = np.asarray(self._com_jit(np.asarray(q, np.float32)))
                # planner expects the chart's [yaw, pitch, roll] ordering
                self.contact_planner.set_state(
                    q[:3], v[:3], q[3:6], com_xyz, self.v_des, self.w_des[2]
                )
            cnt_loc = self.contact_planner.get_locations(node, N + 1)
            base_ref, base_ref_e = self.compute_base_ref_cnt_restricted(q, cnt_loc)
        else:
            base_ref, base_ref_e = self.compute_base_ref_vel_tracking(q)
        # stash for scene-overlay rendering (sim/visual.py MPCVisualCallback)
        self._last_base_ref = base_ref.copy()
        self._last_base_ref_e = base_ref_e.copy()
        self._last_cnt_loc = None if cnt_loc is None else np.asarray(cnt_loc).copy()

        x0 = np.concatenate([q, v]).astype(np.float32)
        plane = np.zeros((4, N + 1, 3), dtype=np.float32)
        plane[:, :, 2] = self._ground
        if cnt_loc is not None:
            # pin active contacts to the planned xy + ground z where provided
            provided = np.all(cnt_loc != 0.0, axis=-1)
            plane[:, :, :2] = np.where(provided[:, :, None], cnt_loc[:, :, :2], 0.0)

        params = make_params(
            self.solver,
            x0,
            cnt,
            peak=peak,
            plane_point=plane,
            cnt_loc=np.zeros((4, N + 1, 3), np.float32) if cnt_loc is None else cnt_loc.astype(np.float32),
            restrict=1.0 if self.restrict_cnt else 0.0,
            base_ref=base_ref.astype(np.float32),
            base_ref_e=base_ref_e.astype(np.float32),
            joint_ref=self.joint_ref.astype(np.float32),
            step_height=self.config_gait.step_height + self._ground,
            ground_height=self._ground,
        )

        if self._X_prev is None and self._boot_jit is not None:
            # cold boot: merit-probe every gait-phase offset and realign the
            # node clock to the winner (the planner phase is free until the
            # first plan is promised to the plant)
            params, off, _ = self._boot_jit(params)
            node = self.resync_phase(node, int(off))

        return self._solve_plan(params, node)

    def resync_phase(self, node: int, offset: int) -> int:
        """Shift the node clock so the planner phase at `node` becomes
        `offset` (mod cycle); keeps the time-based node-advance rule
        consistent. Returns the shifted node."""
        C = self.contact_planner.nodes_per_cycle
        delta = (offset - node) % C
        if delta:
            node += delta
            self.current_opt_node = node
            self._phase_time_offset += delta * self.dt_nodes
        self.boot_offsets.append(offset)
        return node

    def _solve_plan(self, params, node):
        """Warm start (primal + AL duals), solve, interpolate — the shared
        tail of every replan (also used by AcyclicMPC)."""
        N = self.config_opt.n_nodes
        if self._X_prev is None:
            X_prev, U_prev = jax.jit(self.solver.cold_start)(params)
            lam_prev = np.zeros((N, 18), np.float32)
            lami_prev = np.zeros((N, 36), np.float32)
            shift = 0
        else:
            X_prev, U_prev = self._X_prev, self._U_prev
            lam_prev, lami_prev = self._lam_prev, self._lami_prev
            shift = node - self.last_node
        n_iter = self.config_opt.max_iter_first if self.first_solve else self.config_opt.max_iter

        out = self._plan_jit(X_prev, U_prev, lam_prev, lami_prev,
                             jnp.asarray(shift), params, n_iter)
        (X, U, lam, lami, q_plan, v_plan, a_plan, f_plan, tau_ff,
         stats) = jax.block_until_ready(out)
        self._X_prev, self._U_prev = X, U
        self._lam_prev, self._lami_prev = lam, lami
        U_np = np.asarray(U)
        self._last_dt_sol = (
            U_np[:, 30] if U_np.shape[-1] > 30
            else np.full(N, self.dt_nodes)
        )
        self.last_node = node
        if not np.isfinite(np.asarray(stats.cost)):
            raise RuntimeError(f"solver diverged: {stats}")
        return (
            np.asarray(q_plan, np.float64),
            np.asarray(v_plan, np.float64),
            np.asarray(a_plan, np.float64),
            np.asarray(f_plan, np.float64),
            np.asarray(tau_ff, np.float64),
        )

    # ------------------------------------------------------------------
    def _replan(self) -> bool:
        replan = self.sim_step % self.replanning_steps == 0
        if self.solve_async:
            replan &= not self.plan_submitted
        return replan

    def _step(self) -> None:
        self.increment_base_ref_position()
        self.sim_step += 1
        self.plan_step += 1
        if self.plan_step >= self.n_interp_plan:
            self.plan_step = self.n_interp_plan - 1

    def compute_torques_dof(self, mj_data) -> None:
        """1 kHz control: feed-forward from the interpolated plan + joint PD
        (mpc.py:475-599)."""
        t, q_mj, v_mj = mj_data.time, mj_data.qpos, mj_data.qvel
        t = round(t - self.t0, 4)
        q, v = tnp.convert_from_mujoco(np.asarray(q_mj), np.asarray(v_mj))

        if not self.first_solve:
            if t + self._phase_time_offset >= (self.current_opt_node + 1) * self.dt_nodes:
                self.current_opt_node += 1

        if self._replan() and not self.diverged:
            self.start_time = t
            self.optimize_future = self.executor.submit(self.optimize, q, v)
            self.plan_submitted = True
            if self.print_info:
                print(f"## Replan | node {self.current_opt_node} t {t} step {self.sim_step}")
            while not self.solve_async and not self.optimize_future.done():
                time.sleep(1.0e-4)

        if (
            self.plan_submitted
            and self.solve_async
            and self.async_sim_latency is not None
            and not self.first_solve  # first pickup is immediate (delay = 0)
        ):
            # model solver latency in sim time (see __init__ docstring): the
            # plan is picked up exactly `async_sim_latency` sim-seconds after
            # submission — block if the worker is slower than the sim clock.
            if (t - self.start_time) >= self.async_sim_latency - 1e-9:
                try:
                    self.optimize_future.result()
                except Exception:
                    pass  # re-raised (and handled) in the pickup block below
                plan_ready = True
            else:
                plan_ready = False
        elif self.plan_submitted and self.first_solve:
            # block for the very first plan (covers jit compile; the robot
            # holds its pose under the stiff startup PD meanwhile)
            try:
                self.optimize_future.result()
            except Exception:
                pass
            plan_ready = True
        else:
            plan_ready = self.plan_submitted and self.optimize_future.done()

        if plan_ready:
            try:
                q_plan, v_plan, a_plan, f_plan, tau_ff = self.optimize_future.result()
                self.q_plan, self.v_plan, self.a_plan = q_plan, v_plan, a_plan
                self.f_plan, self.tau_ff_plan = f_plan, tau_ff
                if self.solve_async and not self.first_solve:
                    replanning_time = t - self.start_time
                    self.delay = max(math.ceil(replanning_time / self.sim_dt) - 1, 0)
                else:
                    self.delay = 0
                self.plan_step = self.delay
                self.plan_submitted = False
                self.first_solve = False
            except Exception:
                print("Optimization error:\n", traceback.format_exc())
                self.optimize_future = Future()
                self.plan_submitted = False
                if self._recoveries_left > 0:
                    # automatic cold reboot: drop the warm-start state and
                    # re-enter through the phase-aligned cold boot; hold
                    # the CURRENT posture (stiff startup PD) while the
                    # first-solve path recompiles nothing (already cached)
                    self._recoveries_left -= 1
                    self._X_prev = self._U_prev = None
                    self._lam_prev = self._lami_prev = None
                    self.first_solve = True
                    self.q_plan[:] = q[None]
                    self.v_plan[:] = 0.0
                    self._phase_time_offset = (
                        self.current_opt_node * self.dt_nodes)
                    print(f"[mpc] cold reboot after divergence "
                          f"({self._recoveries_left} recoveries left)")
                else:
                    self.diverged = True

        if self.first_solve:
            torques_ff = np.zeros(self.nu)
            self.t0 = mj_data.time
            if np.all(self.q_plan[0] == 0.0):
                self.q_plan[:] = q[None]
            Kp, Kd = 44.0, 5.0
        else:
            torques_ff = self.tau_ff_plan[self.plan_step]
            Kp, Kd = self.Kp, self.Kd
            self.q_full.append(q.copy())
            self.v_full.append(v.copy())
            # time-aligned plan rows for the plan-vs-realized overlays
            k = self.plan_step
            self.q_plan_full.append(self.q_plan[k].copy())
            self.v_plan_full.append(self.v_plan[k].copy())
            self.a_plan_full.append(self.a_plan[k].copy())
            self.f_plan_full.append(self.f_plan[k].copy())
            self.tau_plan_full.append(self.tau_ff_plan[k].copy())
            self.dt_plan_full.append(float(self._last_dt_sol[0]))
            self._step()

        torques_pd = (
            torques_ff
            + Kp * (self.q_plan[self.plan_step, -self.nu:] - q[-self.nu:])
            + Kd * (self.v_plan[self.plan_step, -self.nu:] - v[-self.nu:])
        )
        self.tau_full.append(torques_pd.copy())
        self.torques_dof[-self.nu:] = torques_pd

    # ------------------------------------------------------------------
    def open_loop(self, q_mj: np.ndarray, v_mj: np.ndarray, trajectory_time: float):
        """MPC-in-a-loop without a simulator: integrate the plan forward
        (mpc.py:416-462)."""
        q_traj = []
        sim_time = 0.0
        q, v = tnp.convert_from_mujoco(np.asarray(q_mj), np.asarray(v_mj))
        while sim_time <= trajectory_time:
            if sim_time >= (self.current_opt_node + 1) * self.dt_nodes:
                self.current_opt_node += 1
            if self.sim_step % self.replanning_steps == 0:
                q_plan, v_plan, *_ = self.optimize(q, v)
                self.q_plan, self.v_plan = q_plan, v_plan
                self.plan_step = 0
                self.first_solve = False
            q = self.q_plan[self.plan_step]
            v = self.v_plan[self.plan_step]
            q_mj_k, _ = tnp.convert_to_mujoco(q, v)
            q_traj.append(q_mj_k)
            self._step()
            sim_time += self.sim_dt
        return np.array(q_traj)

    def plot_traj(self, var_name: str, save_path: Optional[str] = None):
        """Plot a recorded trajectory over time, 3 columns per row, with the
        time-aligned PLAN overlaid where both exist (reference `plot_traj` +
        `plot_current_vs_plan`, `mpc.py:601-685`).

        'q'/'v'/'tau': realized (solid) + plan (dashed) overlay.
        'a'/'f'/'dt': plan quantities (no realized measurement exists).
        """
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        spec_map = {
            "q": ("q_full", "q_plan_full"),
            "v": ("v_full", "v_plan_full"),
            "tau": ("tau_full", "tau_plan_full"),
            "a": (None, "a_plan_full"),
            "f": (None, "f_plan_full"),
            "dt": (None, "dt_plan_full"),
        }
        if var_name not in spec_map:
            raise ValueError(f"No recorded trajectory for '{var_name}'."
                             f" Choose from: {sorted(spec_map)}.")
        real_attr, plan_attr = spec_map[var_name]

        def stack(attr):
            rows = getattr(self, attr, None)
            if not rows:
                return None
            arr = np.asarray(rows)
            if arr.ndim == 1:
                arr = arr[:, None]
            return arr.reshape(arr.shape[0], -1)

        traj = stack(real_attr) if real_attr else None
        plan = stack(plan_attr)
        base = traj if traj is not None else plan
        if base is None:
            raise ValueError(f"No recorded data for '{var_name}' yet.")
        N, D = base.shape
        t = np.arange(N) * self.sim_dt
        rows = (D + 2) // 3
        fig, axs = plt.subplots(rows, 3, figsize=(15, 3 * rows))
        axs = np.atleast_1d(axs).ravel()
        for i in range(D):
            if traj is not None:
                axs[i].plot(t, traj[:, i], label="realized")
            if plan is not None:
                tp = np.arange(plan.shape[0]) * self.sim_dt
                axs[i].plot(tp, plan[:, i], "--", label="plan")
            axs[i].set_title(f"{var_name}[{i}]")
            axs[i].grid(True)
            if i == 0 and traj is not None and plan is not None:
                axs[i].legend(loc="best", fontsize=8)
        for i in range(D, len(axs)):
            fig.delaxes(axs[i])
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=110, bbox_inches="tight")
        return fig

    def print_timings(self):
        print()
        print_timings(self.timings)

    def __del__(self):
        try:
            self.executor.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass
        if getattr(self, "velocity_goal", None) is not None:
            self.velocity_goal.stop()
