"""Batched-expert PLANT collector: many MuJoCo envs, ONE vmapped device solve.

The host-plant data bottleneck is the expert: a single CPU-solved combined
rollout collects ~0.1 env-sim-s per wall-second, so reference-protocol
in-plant DAgger is starved to a few rollouts per iteration (measured in
round 5: every checkpoint of a 16-step run was fragile under perturbed
starts). This module restructures collection around the batched solver:

- E MuJoCo instances step on the host at 1 kHz (numpy-only per-step work:
  PD torques from the interpolated plans, numpy policy forward, numpy
  safety monitor — NOTHING touches the device between replans);
- every replanning interval (40 ms) ALL envs replan in ONE vmapped device
  call — `jax.vmap` of LocomotionMPC's plan fn (warm-start shift + GN-SQP
  + Hermite interpolation + RNEA feed-forward), per-env warm starts and
  AL duals carried on device between calls;
- plans are sliced ON DEVICE to the consumed interval before the pull, so
  ~tens of KB cross to the host per replan instead of full-horizon plans.

This is the reference's `rollout_combined_controller` /
`Rollout_MPC` data generation (`DAgger/utils/Rollout_combined_controller.py:
512-631`, `Behavior_Cloning/utils/Rollout_MPC.py:309-516`) run at an
orders-of-magnitude higher rate in the SAME deployment plant — the
measured throughput is printed by scripts/exp_plant_scale.py.

Modes:
- expert-only (`policy_path=None`): batched force-perturbed expert
  rollouts from noisy starts (the BC DataCollection role);
- combined (`policy_path=...`): per-env SafeDAgger monitor + hysteresis
  switching with `is_expert` labels (the DAgger data-step role).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import mujoco
import numpy as np

from ..models import transforms_np as tnp
from ..mpc.controller import LocomotionMPC
from ..robots.spec import RobotSpec
from ..sim.mujoco_sim import Simulator
from ..solver.sqp import make_params
from .recorder import assemble_state
from .rollouts import sample_force_perturbation
from .safety import check_unsafe_state_v2


@dataclass
class BatchRolloutResult:
    # ragged per-env row lists stacked to arrays
    state: np.ndarray          # (rows, 44)
    action: np.ndarray         # (rows, 12)
    vc_goals: np.ndarray       # (rows, 3)
    cc_goals: np.ndarray       # (rows, 8)
    time: np.ndarray           # (rows,)
    env_id: np.ndarray         # (rows,)
    is_expert: np.ndarray      # (rows,)
    sim_time: np.ndarray       # (E,) survived seconds per env
    fell: np.ndarray           # (E,) bool
    expert_ratio: float = 0.0
    wall_s: float = 0.0
    env_sim_s: float = 0.0


class BatchedPlantCollector:
    """E-env MuJoCo collection with a single vmapped device replan."""

    def __init__(
        self,
        spec: RobotSpec,
        n_envs: int = 16,
        gait_name: str = "trot",
        policy_path: Optional[str] = None,
        monitor_height_bounds=None,
        delay_steps: int = 100,
        mpc_min_steps: int = 2500,
    ):
        self.spec = spec
        self.E = n_envs
        self.delay_steps = delay_steps
        self.mpc_min_steps = mpc_min_steps
        self.monitor_height_bounds = monitor_height_bounds
        # template controller: configs, solver, planner, raw plan fn
        self.mpc = LocomotionMPC(spec, gait_name=gait_name,
                                 solve_async=False, compute_timings=False,
                                 phase_aligned_boot=False)
        self.N = self.mpc.config_opt.n_nodes
        self.replan_steps = self.mpc.replanning_steps      # 40
        self.keep = self.replan_steps + 1
        self.Kp, self.Kd = self.mpc.Kp, self.mpc.Kd
        self._tl = np.asarray(spec.torque_limit)

        plan = self.mpc._plan_fn
        keep = self.keep

        def plan_sliced(Xp, Up, lp, lip, shift, params, n_iter):
            (X, U, lam, lami, q_plan, v_plan, a_plan, f_plan, tau_ff,
             stats) = plan(Xp, Up, lp, lip, shift, params, n_iter)
            # only the consumed interval crosses to the host, as ONE array
            # (one device-to-host copy per replan)
            plan_cat = jnp.concatenate(
                [q_plan[:keep], v_plan[:keep], tau_ff[:keep]], axis=-1)
            return (X, U, lam, lami, plan_cat, stats.cost)

        self._plan_b = jax.jit(
            jax.vmap(plan_sliced, in_axes=(0, 0, 0, 0, None, 0, None)),
            static_argnums=6,
        )
        self._cold_b = jax.jit(jax.vmap(self.mpc.solver.cold_start))

        self._policy = None
        if policy_path is not None:
            from .network import make_numpy_apply

            self._policy = make_numpy_apply(policy_path)

    # ------------------------------------------------------------------
    def _batched_params(self, sims, ref_xy_yaw, v_des, node):
        """Per-env OCPParams (numpy) stacked into one batched pytree.
        Mirrors LocomotionMPC.optimize's parameter assembly
        (mpc/controller.py) for the velocity-tracking planner."""
        mpc = self.mpc
        N = self.N
        cnt = mpc.contact_planner.get_contacts(node, N + 1).astype(np.float32)
        peak = (mpc.contact_planner.get_peaks(node, N + 1).astype(np.float32)
                if mpc.config_opt.opt_peak else 1.0 - cnt)
        t_h = mpc.config_opt.time_horizon
        plist = []
        for e, sim in enumerate(sims):
            q, v = tnp.convert_from_mujoco(np.asarray(sim.data.qpos),
                                           np.asarray(sim.data.qvel))
            # velocity-tracking base ref (mpc.py:210-272 semantics)
            base_ref = np.zeros(12)
            base_ref[:2] = np.round(q[:2], 2)
            base_ref[2] = mpc.config_gait.nom_height
            base_ref[3] = round(q[3], 1)
            v_glob = np.round(v_des[e], 2)
            base_ref[6:9] = v_glob
            base_ref_e = base_ref.copy()
            base_ref_e[:2] = ref_xy_yaw[e, :2] + v_glob[:2] * t_h
            base_ref[:2] += (base_ref_e[:2] - base_ref[:2]) * 0.75
            base_ref_e[8] = 0.0
            base_ref_e[4:6] = 0.0
            base_ref[4:6] = 0.0
            x0 = np.concatenate([q, v]).astype(np.float32)
            plist.append(make_params(
                mpc.solver, x0, cnt, peak=peak,
                base_ref=base_ref.astype(np.float32),
                base_ref_e=base_ref_e.astype(np.float32),
                joint_ref=mpc.joint_ref.astype(np.float32),
                step_height=mpc.config_gait.step_height + mpc._ground,
                ground_height=mpc._ground,
            ))
        return jax.tree.map(lambda *xs: np.stack(xs), *plist)

    # ------------------------------------------------------------------
    def collect(
        self,
        v_des: np.ndarray,              # (E, 3)
        sim_time: float = 10.0,
        joint_noise: float = 0.03,
        vel_noise: float = 0.05,
        n_pushes: int = 0,
        seed: int = 0,
        record_expert_only_rows: bool = False,
    ) -> BatchRolloutResult:
        import time as _time

        t_wall = _time.time()
        E, N = self.E, self.N
        rng = np.random.default_rng(seed)
        v_des = np.asarray(v_des, np.float64)
        assert v_des.shape == (E, 3)

        sims: List[Simulator] = []
        pushes = []
        for e in range(E):
            sim = Simulator(self.spec)
            sim.reset()
            if e > 0 and joint_noise > 0:       # env 0 keeps the clean start
                q0 = np.asarray(sim.data.qpos).copy()
                v0 = np.asarray(sim.data.qvel).copy()
                q0[7:] += rng.normal(0, joint_noise, 12)
                v0[:3] += rng.normal(0, vel_noise, 3)
                sim.reset(q_mj=q0, v_mj=v0)
            sims.append(sim)
            if n_pushes > 0 and e % 2 == 1:     # half the envs get pushes
                seg = sim_time / n_pushes
                pushes.append([
                    sample_force_perturbation(rng, i * seg + 1.0,
                                              (i + 1) * seg - 0.5)
                    for i in range(n_pushes)])
            else:
                pushes.append([])

        # device-side per-env solver state
        params = self._batched_params(
            sims, np.stack([np.asarray(s.data.qpos[:2]) for s in sims]),
            v_des, node=0)
        Xp, Up = self._cold_b(params)
        lam = jnp.zeros((E, N, 18), jnp.float32)
        lami = jnp.zeros((E, N, 36), jnp.float32)

        # host loop state
        T = int(round(sim_time / 1e-3))
        active = np.ones(E, bool)
        mode_mpc = np.zeros(E, bool)
        mpc_counter = np.zeros(E, int)
        ref_xy = np.stack([np.asarray(s.data.qpos[:2]) for s in sims])
        rows = {k: [] for k in ("state", "action", "vc", "cc", "t", "env",
                                "exp")}
        n_expert = 0
        n_rows = 0
        node = 0
        first = True
        q_plan = v_plan = tau_plan = None

        for step in range(T):
            t = step * 1e-3
            if t >= (node + 1) * self.mpc.dt_nodes and not first:
                node += 1
            if step % self.replan_steps == 0:
                params = self._batched_params(sims, ref_xy, v_des, node)
                shift = jnp.asarray(1 if not first else 0)
                n_iter = (self.mpc.config_opt.max_iter_first if first
                          else self.mpc.config_opt.max_iter)
                out = self._plan_b(Xp, Up, lam, lami, shift, params, n_iter)
                Xp, Up, lam, lami = out[:4]
                plan_cat = np.asarray(out[4], np.float64)  # (E, keep, 48)
                q_plan = plan_cat[..., :18]
                v_plan = plan_cat[..., 18:36]
                tau_plan = plan_cat[..., 36:]
                first = False
                k_plan = 0
            else:
                k_plan = min(step % self.replan_steps, self.keep - 1)

            # ---- per-env pre-step state, computed ONCE and shared by the
            # policy obs and the recorder rows ----
            states44 = [None] * E
            for e, sim in enumerate(sims):
                if not active[e]:
                    continue
                feet = np.array([sim.data.geom_xpos[g]
                                 for g in sim.foot_geoms])
                states44[e] = assemble_state(
                    np.asarray(sim.data.qpos), np.asarray(sim.data.qvel),
                    feet)

            tau_pol = None
            if self._policy is not None:
                obs = np.zeros((E, 47))
                for e in range(E):
                    if states44[e] is not None:
                        obs[e, :44] = states44[e]
                        obs[e, 44:] = v_des[e]
                act = self._policy(obs)                    # (E, 12)
                tau_pol = np.zeros((E, 12))
                for e, sim in enumerate(sims):
                    if not active[e]:
                        continue
                    qj = np.asarray(sim.data.qpos[7:])
                    vj = np.asarray(sim.data.qvel[6:])
                    tau_pol[e] = 20.0 * (act[e] - qj) - 1.5 * vj

            cc_batch = rng.normal(0.0, 0.1, (E, 8))
            for e, sim in enumerate(sims):
                if not active[e]:
                    continue
                q_mj = np.asarray(sim.data.qpos)
                v_mj = np.asarray(sim.data.qvel)

                # hysteresis switch (Rollout_combined_controller.py:449-482)
                if self._policy is not None:
                    if step >= self.delay_steps:
                        unsafe = check_unsafe_state_v2(
                            q_mj, v_mj, v_des[e],
                            height_bounds=(self.monitor_height_bounds
                                           or (0.18, 0.45)))
                        if mode_mpc[e]:
                            mpc_counter[e] += 1
                            if mpc_counter[e] >= self.mpc_min_steps and not unsafe:
                                mode_mpc[e] = False
                                mpc_counter[e] = 0
                        elif unsafe:
                            mode_mpc[e] = True
                            mpc_counter[e] = 0
                    use_expert = bool(mode_mpc[e])
                else:
                    use_expert = True

                qj, vj = q_mj[7:], v_mj[6:]
                tau_exp = (tau_plan[e, k_plan]
                           + self.Kp * (q_plan[e, k_plan, 6:] - qj)
                           + self.Kd * (v_plan[e, k_plan, 6:] - vj))
                tau = tau_exp if use_expert else tau_pol[e]
                tau = np.clip(tau, -self._tl, self._tl)

                # record BEFORE stepping (recorder contract): action is the
                # realized PD target of the APPLIED torque
                if use_expert or not record_expert_only_rows:
                    rows["state"].append(states44[e])
                    rows["action"].append((tau + 1.5 * vj) / 20.0 + qj)
                    rows["vc"].append(v_des[e])
                    rows["cc"].append(cc_batch[e])
                    rows["t"].append(t)
                    rows["env"].append(e)
                    rows["exp"].append(int(use_expert))
                    n_expert += int(use_expert)
                n_rows += 1

                sim.data.ctrl[:] = tau
                sim.data.xfrc_applied[sim.trunk_body][:] = 0.0
                for fw in pushes[e]:
                    if fw.start <= t < fw.end:
                        f6 = np.zeros(6)
                        f6[:3] = fw.force
                        sim.data.xfrc_applied[sim.trunk_body][:] += f6
                mujoco.mj_step(sim.model, sim.data)
                if sim._bad_collision():
                    active[e] = False
                ref_xy[e] += np.round(v_des[e][:2], 2) * 1e-3
            if not active.any():
                break

        wall = _time.time() - t_wall
        sim_s = np.array([s.data.time for s in sims])
        res = BatchRolloutResult(
            state=np.asarray(rows["state"]),
            action=np.asarray(rows["action"]),
            vc_goals=np.asarray(rows["vc"]),
            cc_goals=np.asarray(rows["cc"]),
            time=np.asarray(rows["t"]),
            env_id=np.asarray(rows["env"]),
            is_expert=np.asarray(rows["exp"]),
            sim_time=sim_s,
            fell=~active,
            expert_ratio=n_expert / max(n_rows, 1),
            wall_s=wall,
            env_sim_s=float(sim_s.sum()),
        )
        return res
