"""Batched-expert plant collector: correctness smoke on the CPU backend.

This pins the MECHANICS (throughput is measured on the GPU, not here): E envs step MuJoCo under one vmapped replan, rows follow the
recorder contract, the combined mode labels is_expert, and a healthy
expert keeps every env upright over the short budget.
"""
import numpy as np
import pytest

from iterative_learning_nmpc_tpu.learning.plant_batch import (
    BatchedPlantCollector,
)


@pytest.mark.slow
def test_batched_expert_collect_mechanics(go2):
    E = 2
    coll = BatchedPlantCollector(go2, n_envs=E)
    # small iteration budgets keep the vmapped-plan compile light on CPU
    coll.mpc.config_opt.max_iter_first = 4
    v = np.zeros((E, 3))
    v[:, 0] = (0.15, 0.0)
    res = coll.collect(v, sim_time=0.2, joint_noise=0.02, seed=3)

    assert res.state.shape[1] == 44
    assert res.action.shape[1] == 12
    assert res.vc_goals.shape[1] == 3
    assert len(res.state) == len(res.action) == len(res.is_expert)
    # expert-only mode: every row expert-labeled
    assert res.is_expert.all()
    assert res.expert_ratio == 1.0
    # both envs survive 0.2 s under the expert
    assert not res.fell.any(), res.sim_time
    assert (res.sim_time >= 0.2 - 1e-6).all()
    # both envs contributed rows; per-env goals recorded
    for e in range(E):
        m = res.env_id == e
        assert m.sum() >= 190
        assert np.allclose(res.vc_goals[m][0], v[e])
    # actions are PD targets near the joint configuration (recorder
    # contract: (tau + kd v)/kp + q -- bounded by joint limits)
    jl = np.asarray(go2.joint_limits)
    assert (res.action >= jl[:, 0] - 0.8).all()
    assert (res.action <= jl[:, 1] + 0.8).all()
