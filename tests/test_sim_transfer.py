"""jax_sim-vs-MuJoCo pins on a WALKING trajectory.

The soft-contact device sim (`sim/jax_sim.py`) backs the flagship on-device
datagen/DAgger loop; previously it was pinned against the MuJoCo oracle only
on standing/freefall scenarios (`test_jax_sim.py`). These tests pin it on a
real Go2 trot:

- identical raw torques reproduce the MuJoCo base state over >= half a gait
  cycle (open-loop walking is exponentially unstable, so the horizon where
  raw-torque comparison is meaningful is bounded by the plant's Lyapunov
  time, not sim fidelity);
- a PD-target replay (the reference's dataset-sanity protocol,
  `Behavior_Cloning/utils/Rollout_MPC_replay.py:173-240`) stays on the
  MuJoCo trajectory for 2 full gait cycles and keeps walking.

Measured divergence (scripts/check_sim_transfer.py, 2026-08):
  raw torque @250 ms: 5.4 mm xy / 6.4 mm z / 0.015 rad tilt
  PD target  @1.0 s : 5.5 cm xy / 1.6 cm z / 0.068 rad tilt, no fall
Bounds below carry ~4-6x margin.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from iterative_learning_nmpc_tpu.models import transforms_np as tnp
from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
from iterative_learning_nmpc_tpu.sim import jax_sim
from iterative_learning_nmpc_tpu.sim.mujoco_sim import DataRecorder, Simulator


class _TorqueRecorder(DataRecorder):
    def __init__(self):
        super().__init__()
        self.q, self.v, self.ctrl = [], [], []

    def record(self, mj_data):
        self.q.append(np.asarray(mj_data.qpos).copy())
        self.v.append(np.asarray(mj_data.qvel).copy())
        self.ctrl.append(np.asarray(mj_data.ctrl).copy())


@pytest.fixture(scope="module")
def walking_traj(go2):
    """1 s of recorded Go2 trot in MuJoCo under the MPC expert.

    phase_aligned_boot is pinned OFF: this fixture feeds sim-transfer
    ORACLE pins whose tolerances were calibrated on the offset-0 boot
    trajectory (the merit boot picks offset 11 from home and shifts the
    whole gait phase, moving the 1 s replay drift from 0.13 to 0.157 m —
    same transfer quality, different trajectory)."""
    sim = Simulator(go2)
    mpc = LocomotionMPC(go2, gait_name="trot", solve_async=False,
                        phase_aligned_boot=False)
    mpc.set_command(np.array([0.3, 0.0, 0.0]))
    rec = _TorqueRecorder()
    res = sim.run(sim_time=1.0, controller=mpc, data_recorder=rec)
    assert not res.fell and not res.diverged
    return np.stack(rec.q), np.stack(rec.v), np.stack(rec.ctrl)


def _mujoco_chart_traj(Qm, Vm):
    return np.stack(
        [tnp.convert_from_mujoco(q, v)[0] for q, v in zip(Qm, Vm)]
    )


@pytest.mark.slow
def test_torque_replay_tracks_half_gait_cycle(go2, walking_traj):
    Qm, Vm, TAU = walking_traj
    q0c, v0c = tnp.convert_from_mujoco(Qm[0], Vm[0])
    st = jax_sim.SimState(jnp.asarray(q0c, jnp.float32),
                          jnp.asarray(v0c, jnp.float32),
                          jnp.asarray(0.0, jnp.float32))
    cp = jax_sim.contact_params_for(go2)

    def body(s, tau):
        s2 = jax_sim.step(go2, s, tau, cp, 1.0e-3)
        return s2, s2.q

    _, Qj = jax.jit(lambda s, taus: jax.lax.scan(body, s, taus))(
        st, jnp.asarray(TAU, jnp.float32))
    Qj = np.asarray(Qj)
    Qc = _mujoco_chart_traj(Qm[1:], Vm[1:])  # state after step k = row k+1

    k = 250  # half a trot cycle (gait period 0.5 s, mpc/config.py:185)
    assert np.linalg.norm(Qj[k, :2] - Qc[k, :2]) < 0.03
    assert abs(Qj[k, 2] - Qc[k, 2]) < 0.03
    assert np.abs(Qj[k, 4:6] - Qc[k, 4:6]).max() < 0.10


@pytest.mark.slow
def test_pd_replay_tracks_two_gait_cycles(go2, walking_traj):
    """Reference ReplayController protocol: realized PD targets
    (`Rollout_MPC.py:298` encoding) replayed in jax_sim stay on the MuJoCo
    walking trajectory for 2 full gait cycles."""
    Qm, Vm, TAU = walking_traj
    kp, kd = 20.0, 1.5
    A = (TAU + kd * Vm[:, 6:]) / kp + Qm[:, 7:]

    q0c, v0c = tnp.convert_from_mujoco(Qm[0], Vm[0])
    st = jax_sim.SimState(jnp.asarray(q0c, jnp.float32),
                          jnp.asarray(v0c, jnp.float32),
                          jnp.asarray(0.0, jnp.float32))
    cp = jax_sim.contact_params_for(go2)

    def body(s, a):
        tau = kp * (a - s.q[6:]) - kd * s.v[6:]
        s2 = jax_sim.step(go2, s, tau, cp, 1.0e-3)
        return s2, s2.q

    _, Qp = jax.jit(lambda s, acts: jax.lax.scan(body, s, acts))(
        st, jnp.asarray(A, jnp.float32))
    Qp = np.asarray(Qp)
    Qc = _mujoco_chart_traj(Qm[1:], Vm[1:])
    T = min(len(Qp), len(Qc))

    # never falls, stays upright the whole second
    assert Qp[:T, 2].min() > 0.20
    assert np.abs(Qp[:T, 4:6]).max() < 0.3

    k = T - 1  # ~2 gait cycles
    assert np.linalg.norm(Qp[k, :2] - Qc[k, :2]) < 0.15
    assert abs(Qp[k, 2] - Qc[k, 2]) < 0.05
    assert np.abs(Qp[k, 4:6] - Qc[k, 4:6]).max() < 0.2
    # similar forward progress: the replayed robot WALKS, not just stands
    prog_mj = Qc[k, 0] - Qc[0, 0]
    prog_jx = Qp[k, 0] - Qp[0, 0]
    assert prog_jx > 0.5 * prog_mj > 0.1
