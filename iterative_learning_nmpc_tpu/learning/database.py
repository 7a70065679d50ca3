"""Replay-buffer dataset with the reference's exact semantics.

Re-implements `Behavior_Cloning/utils/database.py` (== `DAgger/utils/database.py`)
without torch: a ring buffer of (state, action, vc_goal, cc_goal, traj_id,
traj_time) with `limit` + overflow wraparound (`database.py:123-137`),
normalization over states EXCLUDING column 0 — the gait-phase column —
(`database.py:208-235`), vc-goal passthrough normalization
(`database.py:244-247`), HDF5 snapshots and NPZ save/load
(`database.py:156-206, 274-314`).

Contiguous numpy storage instead of python object lists — O(1) vectorized
append and zero-copy batch gather for the JAX training loop. A C++ native
backend (native/fastbuffer) can be swapped in for the hot append/sample path.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np


class Database:
    GROUPS = ("states", "vc_goals", "cc_goals", "actions")

    def __init__(self, limit: int, norm_input: bool = True, goal_type: str = "vc"):
        assert goal_type in ("vc", "cc"), "Goal type can only be vc or cc"
        self.limit = int(limit)
        self.length = 0
        self.start = 0
        self.goal_type = goal_type
        self.norm_input = norm_input

        self.states: Optional[np.ndarray] = None
        self.actions: Optional[np.ndarray] = None
        self.vc_goals: Optional[np.ndarray] = None
        self.cc_goals: Optional[np.ndarray] = None
        self.traj_ids: Optional[np.ndarray] = None
        self.traj_times: Optional[np.ndarray] = None
        # per-row OOD flag (L2-vs-time-aligned-nominal > threshold — the
        # reference's WeightedRandomSampler x5 input, test_train_policy.py:127-134)
        self.ood: Optional[np.ndarray] = None

        self.states_mean = None
        self.states_std = None
        self.vc_goals_mean = 0.0
        self.vc_goals_std = 1.0
        self.cc_goals_mean = None
        self.cc_goals_std = None
        self._stats_dirty = True

    # ------------------------------------------------------------------
    def __len__(self):
        return self.length

    def _order(self):
        """Logical order indices of the ring buffer."""
        return (self.start + np.arange(self.length)) % self.limit

    def _alloc(self, states, actions, vc_goals, cc_goals):
        def buf(sample, width_default=None):
            width = np.shape(sample)[-1] if sample is not None else width_default
            return np.zeros((self.limit, width), dtype=np.float64) if width else None

        self.states = buf(states)
        self.actions = buf(actions)
        self.vc_goals = buf(vc_goals)
        self.cc_goals = buf(cc_goals)
        self.traj_ids = np.zeros(self.limit, dtype=np.int64)
        self.traj_times = np.zeros(self.limit, dtype=np.float64)
        self.ood = np.zeros(self.limit, dtype=np.bool_)

    def append(self, states, actions, vc_goals=None, cc_goals=None, traj_id=None, times=None,
               ood=None):
        if vc_goals is None and cc_goals is None:
            raise ValueError("both vc_goals and cc_goals cant be empty!")
        states = np.atleast_2d(np.asarray(states))
        actions = np.atleast_2d(np.asarray(actions))
        n = len(states)
        if self.states is None:
            self._alloc(states[0], actions[0],
                        None if vc_goals is None else np.atleast_2d(vc_goals)[0],
                        None if cc_goals is None else np.atleast_2d(cc_goals)[0])

        idx = (self.start + self.length + np.arange(n)) % self.limit
        overflow = self.length + n - self.limit
        if overflow > 0:
            self.start = (self.start + overflow) % self.limit
            self.length = self.limit
        else:
            self.length += n

        self.states[idx] = states
        self.actions[idx] = actions
        if vc_goals is not None:
            self.vc_goals[idx] = np.atleast_2d(np.asarray(vc_goals))
        if cc_goals is not None and self.cc_goals is not None:
            self.cc_goals[idx] = np.atleast_2d(np.asarray(cc_goals))
        if traj_id is not None:
            self.traj_ids[idx] = np.asarray(traj_id)
        if times is not None:
            self.traj_times[idx] = np.asarray(times)
        if ood is not None:
            self.ood[idx] = np.asarray(ood, dtype=bool)

        # stats are recomputed lazily on first use (appending is O(rows
        # added); a full-buffer rescan per append would make DAgger
        # aggregation quadratic)
        self._stats_dirty = True

    # ------------------------------------------------------------------
    def _ensure_stats(self):
        if self._stats_dirty:
            self.calc_input_mean_std()

    def calc_input_mean_std(self):
        """Per-dim mean/std over states, EXCLUDING column 0 (gait phase) from
        normalization (reference `database.py:208-235`)."""
        s = self.states_array()
        self.states_mean = s.mean(axis=0)
        self.states_std = s.std(axis=0)
        if self.cc_goals is not None and self.length:
            cc = self.cc_goals[self._order()]
            self.cc_goals_mean = cc.mean(axis=0)
            self.cc_goals_std = cc.std(axis=0)
        self._stats_dirty = False

    def normalize_states(self, states: np.ndarray) -> np.ndarray:
        self._ensure_stats()
        out = np.array(states, dtype=np.float64, copy=True)
        std = np.where(self.states_std[1:] > 1e-8, self.states_std[1:], 1.0)
        out[..., 1:] = (out[..., 1:] - self.states_mean[1:]) / std
        return out

    def states_array(self):
        return self.states[self._order()] if self.length else np.zeros((0, 1))

    def actions_array(self):
        return self.actions[self._order()]

    def ood_array(self):
        """Per-row OOD flags in logical order (all False when never set)."""
        if self.length == 0 or self.ood is None:
            return np.zeros(0, dtype=bool)
        return self.ood[self._order()]

    def goals_array(self):
        if self.goal_type == "vc":
            return self.vc_goals[self._order()]
        return self.cc_goals[self._order()]

    # ------------------------------------------------------------------
    def __getitem__(self, index):
        """(x = [state || goal], y = action), with normalization applied as
        configured (reference `database.py:55-85`)."""
        self._ensure_stats()
        order = self._order()
        i = order[index]
        state = self.states[i]
        if self.norm_input:
            state = self.normalize_states(state)
        if self.goal_type == "vc":
            goal = self.vc_goals[i]
            if self.norm_input:
                goal = (goal - self.vc_goals_mean) / self.vc_goals_std
        else:
            goal = self.cc_goals[i]
            if self.norm_input:
                std = np.where(self.cc_goals_std > 1e-8, self.cc_goals_std, 1.0)
                goal = (goal - self.cc_goals_mean) / std
        return np.concatenate([state, goal], axis=-1), self.actions[i]

    def training_arrays(self):
        """Full (X, Y) for the vectorized JAX training loop."""
        states = self.states_array()
        if self.norm_input:
            states = self.normalize_states(states)
        goals = self.goals_array()
        if self.goal_type == "vc" and self.norm_input:
            goals = (goals - self.vc_goals_mean) / self.vc_goals_std
        X = np.concatenate([states, goals], axis=-1)
        return X.astype(np.float32), self.actions_array().astype(np.float32)

    def get_database_mean_std(self):
        if not self.norm_input:
            return None
        self._ensure_stats()
        if self.goal_type == "vc":
            return [self.states_mean, self.states_std, self.vc_goals_mean, self.vc_goals_std]
        return [self.states_mean, self.states_std, self.cc_goals_mean, self.cc_goals_std]

    # ------------------------------------------------------------------
    def save_as_hdf5(self, filename: str, config=None):
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        import h5py

        order = self._order()
        with h5py.File(filename, "w") as hf:
            hf.create_dataset("states", data=self.states[order])
            hf.create_dataset("actions", data=self.actions[order])
            if self.vc_goals is not None:
                hf.create_dataset("vc_goals", data=self.vc_goals[order])
            if self.cc_goals is not None:
                hf.create_dataset("cc_goals", data=self.cc_goals[order])
            hf.create_dataset("traj_ids", data=self.traj_ids[order])
            hf.create_dataset("traj_times", data=self.traj_times[order])
            hf.create_dataset("ood", data=self.ood[order])
        if config is not None:
            with open(os.path.splitext(filename)[0] + "_config.pkl", "wb") as f:
                pickle.dump(config, f)
        return filename

    def load_saved_database(self, filename: str):
        import h5py

        with h5py.File(filename, "r") as hf:
            states = hf["states"][:]
            actions = hf["actions"][:]
            vc_goals = hf["vc_goals"][:] if "vc_goals" in hf else None
            cc_goals = hf["cc_goals"][:] if "cc_goals" in hf else None
            traj_ids = hf["traj_ids"][:] if "traj_ids" in hf else None
            traj_times = hf["traj_times"][:] if "traj_times" in hf else None
            ood = hf["ood"][:] if "ood" in hf else None
        self.append(states, actions, vc_goals=vc_goals, cc_goals=cc_goals,
                    traj_id=traj_ids, times=traj_times, ood=ood)

    def save_as_npz(self, filename: str):
        order = self._order()
        np.savez(
            filename,
            states=self.states[order],
            vc_goals=self.vc_goals[order] if self.vc_goals is not None else np.zeros(0),
            cc_goals=self.cc_goals[order] if self.cc_goals is not None else np.zeros(0),
            actions=self.actions[order],
        )

    def load_from_npz(self, filename: str):
        data = np.load(filename)
        for f in ("states", "vc_goals", "cc_goals", "actions"):
            if f not in data:
                raise ValueError(f"Missing field '{f}' in NPZ file.")
        self.append(
            data["states"], data["actions"],
            vc_goals=data["vc_goals"] if data["vc_goals"].size else None,
            cc_goals=data["cc_goals"] if data["cc_goals"].size else None,
        )
