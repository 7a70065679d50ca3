"""LocoSafeDAgger: iterative expert-relabeled imitation learning.

Re-implements the reference's L4 orchestration:
- `SafeDaggerDataCollection` (`DAgger/utils/data_collection_locosafedagger.py:22-231`):
  one combined-controller rollout, keep ONLY expert-labeled timesteps,
  aggregate with the previous dataset into `agg_dataset.hdf5`, report the
  expert-influence ratio.
- `SafeDaggerTraining` (`DAgger/utils/train_locosafedagger.py:34-200`):
  warm-started fine-tuning on the aggregated dataset (15 epochs, Adam 1e-3).
- `SafeDaggerPipeline` (`DAgger/example/iter_locosafedagger.py:16-112`):
  (collect -> aggregate -> train)^n per velocity goal, threading policy and
  dataset paths between stages.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..robots.spec import RobotSpec
from .database import Database
from .rollouts import rollout_combined
from .train import BehavioralCloning, TrainConfig


@dataclass
class SafeDaggerConfig:
    record_dir: str = "./dagger"
    sim_time: float = 10.0
    gait_name: str = "trot"
    database_size: int = 10_000_000
    n_epochs: int = 15
    learning_rate: float = 1.0e-3
    batch_size: int = 256
    monitor: str = "v2"
    delay_steps: int = 100
    mpc_min_steps: int = 2500
    goals: Sequence[Sequence[float]] = ((0.15, 0.0, 0.0), (0.0, 0.0, 0.0), (-0.15, 0.0, 0.0))
    n_iterations_per_goal: int = 4
    seed: int = 0
    # on-device collect extras (OnDeviceSafeDagger only):
    # initial-state base randomization — z offset / pitch-roll / base linear
    # velocity noise stds. Nonzero z/rpy noise makes the expert demonstrate
    # recovery from height droop and tilt, the measured 0.3 m/s
    # sim-to-oracle failure mode (docs/TRANSFER.md).
    x0_z_noise: float = 0.0
    x0_rpy_noise: float = 0.0
    x0_vel_noise: float = 0.0
    # optional tighter monitor height band for drift-triggered relabeling
    unsafe_height_bounds: Optional[Sequence[float]] = None


class SafeDaggerDataCollection:
    def __init__(self, spec: RobotSpec, cfg: SafeDaggerConfig):
        self.spec = spec
        self.cfg = cfg
        self.expert_ratio_history: List[float] = []

    def collect(self, policy_path: str, v_des, prev_dataset: Optional[str],
                tag: str) -> str:
        """One DAgger data step: rollout, filter expert rows, aggregate."""
        cfg = self.cfg
        out_dir = os.path.join(cfg.record_dir, tag)
        os.makedirs(out_dir, exist_ok=True)
        rollout = rollout_combined(
            self.spec, policy_path, sim_time=cfg.sim_time,
            v_des=np.asarray(v_des), gait_name=cfg.gait_name,
            record_dir=out_dir, monitor=cfg.monitor,
            delay_steps=cfg.delay_steps, mpc_min_steps=cfg.mpc_min_steps,
        )
        rec = rollout.recorder
        is_expert = np.asarray(rec.data["is_expert"], dtype=bool)
        ratio = float(is_expert.mean()) if len(is_expert) else 0.0
        self.expert_ratio_history.append(ratio)
        print(f"[dagger] {tag}: expert-influence ratio {ratio:.3f} "
              f"({is_expert.sum()}/{len(is_expert)} steps)")

        db = Database(limit=cfg.database_size, goal_type="vc")
        if prev_dataset is not None and os.path.exists(prev_dataset):
            db.load_saved_database(prev_dataset)
        if is_expert.any():
            # keep only expert-labeled timesteps (reference `:179-206`)
            states = np.asarray(rec.data["state"])[is_expert]
            actions = np.asarray(rec.data["action"])[is_expert]
            vc = np.asarray(rec.data["vc_goals"])[is_expert]
            cc = np.asarray(rec.data["cc_goals"])[is_expert]
            times = np.asarray(rec.data["time"])[is_expert]
            db.append(states, actions, vc_goals=vc, cc_goals=cc,
                      traj_id=np.full(len(states), len(self.expert_ratio_history)),
                      times=times)
        agg_path = os.path.join(out_dir, "agg_dataset.hdf5")
        db.save_as_hdf5(agg_path, config=cfg)
        return agg_path


class SafeDaggerPipeline:
    """The outer iterative-learning loop (reference `iter_locosafedagger.py`)."""

    def __init__(self, spec: RobotSpec, cfg: SafeDaggerConfig,
                 initial_policy: str, initial_dataset: Optional[str] = None):
        self.spec = spec
        self.cfg = cfg
        self.policy_path = initial_policy
        self.dataset_path = initial_dataset
        self.collector = SafeDaggerDataCollection(spec, cfg)

    def run_training(self, dataset_path: str, tag: str) -> str:
        cfg = self.cfg
        db = Database(limit=cfg.database_size, goal_type="vc")
        db.load_saved_database(dataset_path)
        if len(db) < cfg.batch_size:
            print(f"[dagger] {tag}: dataset too small ({len(db)}), skip training")
            return self.policy_path
        tc = TrainConfig(
            learning_rate=cfg.learning_rate,
            batch_size=cfg.batch_size,
            n_epochs=cfg.n_epochs,
            save_dir=os.path.join(cfg.record_dir, "policies"),
            run_name=tag,
            seed=cfg.seed,
        )
        bc = BehavioralCloning(tc)
        return bc.run(db, warm_start_path=self.policy_path)

    def run(self) -> str:
        """(collect -> train) x n_iterations per goal; returns final policy."""
        for gi, goal in enumerate(self.cfg.goals):
            for it in range(self.cfg.n_iterations_per_goal):
                tag = f"goal{gi}_iter{it}"
                self.dataset_path = self.collector.collect(
                    self.policy_path, goal, self.dataset_path, tag
                )
                self.policy_path = self.run_training(self.dataset_path, tag)
        return self.policy_path


class OnDeviceSafeDagger:
    """Fully on-device LocoSafeDAgger outer loop (beyond-reference; semantics
    mirror `SafeDaggerPipeline` / reference `iter_locosafedagger.py:16-112`
    with the single MuJoCo rollout replaced by `batch` parallel on-device
    combined-controller rollouts per data step —
    `ondevice.make_batched_mpc_rollout(policy=...)`). The rollout compiles
    ONCE; each iteration's retrained weights + norm stats enter as traced
    arguments (`policy_update`), so the whole (collect -> relabel ->
    aggregate -> retrain) loop runs with zero recompilation.
    """

    def __init__(self, spec: RobotSpec, cfg: SafeDaggerConfig,
                 initial_policy: str, initial_dataset: Optional[str] = None,
                 batch: int = 32, joint_noise: float = 0.03,
                 randomize: bool = False,
                 payload_kwargs: Optional[dict] = None,
                 terrain_kwargs: Optional[dict] = None):
        import jax
        import jax.numpy as jnp

        from ..models import dynamics as dyn
        from .network import load_policy
        from .ondevice import make_batched_mpc_rollout

        self.spec = spec
        self.cfg = cfg
        self.batch = batch
        self.joint_noise = joint_noise
        self.randomize = randomize
        self.payload_kwargs = payload_kwargs or {}
        self.terrain_kwargs = terrain_kwargs or {}
        self.policy_path = initial_policy
        self.dataset_path = initial_dataset
        self.expert_ratio_history: List[float] = []

        net, variables, norm = load_policy(initial_policy)
        if norm is None:
            # identity norm stats: keeps the traced-pytree structure stable
            # when retrained policies (which always carry norm) slot in
            norm = (np.zeros(44, np.float32), np.ones(44, np.float32),
                    np.zeros(3, np.float32), np.ones(3, np.float32))
        self._net = net
        # one jitted rollout for every iteration (dt_nodes = 40 ms)
        self.n_intervals = max(1, int(round(cfg.sim_time / 0.04)))
        self.rollout = make_batched_mpc_rollout(
            spec, gait_name=cfg.gait_name, n_intervals=self.n_intervals,
            policy=(net, variables, norm),
            delay_steps=cfg.delay_steps, mpc_min_steps=cfg.mpc_min_steps,
            unsafe_height_bounds=(tuple(cfg.unsafe_height_bounds)
                                  if cfg.unsafe_height_bounds else None))

        # settled nominal state (as examples/ondevice_datagen.py)
        q0 = np.asarray(spec.q_home, np.float32).copy()
        p0 = np.asarray(jax.jit(lambda q: dyn.foot_positions(spec, q))(q0))
        q0[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
        self._x0 = np.concatenate([q0, np.zeros(18, np.float32)])
        self._rng = np.random.default_rng(cfg.seed)
        self._jnp = jnp

    def _load_update(self, path):
        from .network import load_policy

        _, variables, norm = load_policy(path)
        if norm is None:
            norm = (np.zeros(44, np.float32), np.ones(44, np.float32),
                    np.zeros(3, np.float32), np.ones(3, np.float32))
        return variables, norm

    def collect(self, policy_path: str, v_des, prev_dataset: Optional[str],
                tag: str) -> str:
        """One on-device DAgger data step: B combined-controller rollouts,
        expert-row filter (`data_collection_locosafedagger.py:179-206`),
        aggregation into agg_dataset.hdf5."""
        import jax

        cfg, B, jnp = self.cfg, self.batch, self._jnp
        out_dir = os.path.join(cfg.record_dir, tag)
        os.makedirs(out_dir, exist_ok=True)

        x0b = np.tile(self._x0[None], (B, 1))
        x0b[:, 6:18] += self._rng.normal(
            0, self.joint_noise, (B, 12)).astype(np.float32)
        # base-state randomization: recovery-from-drift training data
        # (chart layout: z at 2, [yaw, pitch, roll] at 3:6, base vel 18:21)
        if cfg.x0_z_noise > 0:
            x0b[:, 2] += np.clip(
                self._rng.normal(0, cfg.x0_z_noise, B),
                -2.5 * cfg.x0_z_noise, 2.5 * cfg.x0_z_noise
            ).astype(np.float32)
        if cfg.x0_rpy_noise > 0:
            x0b[:, 4:6] += self._rng.normal(
                0, cfg.x0_rpy_noise, (B, 2)).astype(np.float32)
        if cfg.x0_vel_noise > 0:
            x0b[:, 18:21] += self._rng.normal(
                0, cfg.x0_vel_noise, (B, 3)).astype(np.float32)
        vdes = np.tile(np.asarray(v_des, np.float32)[None], (B, 1))

        ps = tr = fw = None
        if self.randomize:
            # per-iteration domain randomization (payload + terrain/contact
            # + scheduled reference-magnitude pushes on half the envs) —
            # robustness data for sim-to-oracle transfer; the CONTROLLER
            # model stays nominal (model-plant mismatch by design)
            from .randomize import (
                randomize_payload,
                randomize_terrain,
                sample_force_windows,
            )

            it = len(self.expert_ratio_history)
            ps = randomize_payload(
                self.spec, jax.random.PRNGKey(cfg.seed + 7919 * it), B,
                **self.payload_kwargs)
            tr = randomize_terrain(
                jax.random.PRNGKey(cfg.seed + 104729 * it), B,
                **self.terrain_kwargs)
            fw = np.array(sample_force_windows(
                jax.random.PRNGKey(cfg.seed + 1299709 * it), B,
                self.n_intervals * 40))
            fw[: B // 2] = 0.0  # half the envs stay push-free
            fw = jnp.asarray(fw, jnp.float32)
        out = self.rollout(jnp.asarray(x0b), jnp.asarray(vdes), ps, tr,
                           policy_update=self._load_update(policy_path),
                           force_windows=fw)
        jax.block_until_ready(out.q)

        T = out.state44.shape[1]
        keep = (np.asarray(out.valid) > 0.5) & (np.asarray(out.is_expert) > 0.5)
        n_steps = int(np.asarray(out.valid).sum())
        ratio = float(keep.sum() / max(n_steps, 1))
        self.expert_ratio_history.append(ratio)
        print(f"[dagger-device] {tag}: expert-influence ratio {ratio:.3f} "
              f"({int(keep.sum())}/{n_steps} valid steps, {B} envs)")

        db = Database(limit=cfg.database_size, goal_type="vc")
        if prev_dataset is not None and os.path.exists(prev_dataset):
            db.load_saved_database(prev_dataset)
        if keep.any():
            flat = keep.reshape(-1)
            states = np.asarray(out.state44).reshape(-1, 44)[flat]
            actions = np.asarray(out.action).reshape(-1, 12)[flat]
            goals = np.repeat(vdes, T, axis=0)[flat]
            times = np.tile(np.arange(T) * 1e-3, B)[flat]
            ids = np.repeat(np.arange(B), T)[flat] \
                + 1000 * len(self.expert_ratio_history)
            db.append(states, actions, vc_goals=goals, traj_id=ids,
                      times=times)
        if len(db) == 0:
            # every env fell during the hysteresis delay and nothing was
            # relabeled — keep the previous dataset for the training step
            print(f"[dagger-device] {tag}: no expert rows collected")
            return prev_dataset
        agg_path = os.path.join(out_dir, "agg_dataset.hdf5")
        db.save_as_hdf5(agg_path, config=cfg)
        return agg_path

    def run_training(self, dataset_path: str, tag: str) -> str:
        cfg = self.cfg
        db = Database(limit=cfg.database_size, goal_type="vc")
        db.load_saved_database(dataset_path)
        if len(db) < cfg.batch_size:
            print(f"[dagger-device] {tag}: dataset too small ({len(db)}), "
                  "skip training")
            return self.policy_path
        tc = TrainConfig(
            learning_rate=cfg.learning_rate,
            batch_size=cfg.batch_size,
            n_epochs=cfg.n_epochs,
            save_dir=os.path.join(cfg.record_dir, "policies"),
            run_name=tag,
            seed=cfg.seed,
        )
        bc = BehavioralCloning(tc)
        return bc.run(db, warm_start_path=self.policy_path)

    def run(self) -> str:
        """(collect -> train) x n_iterations per goal; returns final policy."""
        for gi, goal in enumerate(self.cfg.goals):
            for it in range(self.cfg.n_iterations_per_goal):
                tag = f"goal{gi}_iter{it}"
                self.dataset_path = self.collect(
                    self.policy_path, goal, self.dataset_path, tag)
                if self.dataset_path is not None:
                    self.policy_path = self.run_training(
                        self.dataset_path, tag)
        return self.policy_path
