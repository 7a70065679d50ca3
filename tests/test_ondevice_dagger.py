"""Fully on-device SafeDAgger outer loop (collect -> relabel -> aggregate ->
retrain), reference semantics from `DAgger/example/iter_locosafedagger.py`
with the data step batched on device — plus the MuJoCo-oracle transfer test:
a policy trained entirely on jax_sim data must drive
the real plant under the safety monitor."""
import os

import numpy as np
import pytest

import jax

from iterative_learning_nmpc_tpu.learning.dagger import (
    OnDeviceSafeDagger,
    SafeDaggerConfig,
)
from iterative_learning_nmpc_tpu.learning.database import Database
from iterative_learning_nmpc_tpu.learning.network import (
    init_network,
    load_policy,
    save_policy,
)


@pytest.mark.slow
def test_ondevice_dagger_outer_loop(go2, tmp_path):
    """Two full iterations: the (untrained) policy is unsafe, the expert
    takes over, expert rows aggregate, the policy retrains warm-started —
    and the single compiled rollout is reused across iterations (retrained
    weights + norm enter as traced arguments)."""
    net, variables = init_network(
        jax.random.PRNGKey(0), 47, 12, num_hidden_layer=2, hidden_dim=32)
    policy0 = save_policy(
        str(tmp_path / "policy0.pkl"), variables, None,
        dict(input_size=47, output_size=12, num_hidden_layer=2,
             hidden_dim=32, batch_norm=True, dropout_rate=0.0))

    cfg = SafeDaggerConfig(
        record_dir=str(tmp_path / "dagger"),
        sim_time=0.32,                    # 8 replan intervals
        database_size=100_000,
        n_epochs=2,
        batch_size=64,
        delay_steps=20,
        mpc_min_steps=60,
        goals=((0.3, 0.0, 0.0),),
        n_iterations_per_goal=2,
    )
    pipe = OnDeviceSafeDagger(go2, cfg, policy0, batch=2)
    final_policy = pipe.run()

    # both iterations ran a data step; the unsafe policy forced the expert in
    assert len(pipe.expert_ratio_history) == 2
    assert pipe.expert_ratio_history[0] > 0.3

    # aggregation grows across iterations
    d0 = Database(limit=10**6)
    d0.load_saved_database(
        os.path.join(cfg.record_dir, "goal0_iter0", "agg_dataset.hdf5"))
    d1 = Database(limit=10**6)
    d1.load_saved_database(
        os.path.join(cfg.record_dir, "goal0_iter1", "agg_dataset.hdf5"))
    assert len(d1) > len(d0) > 0

    # the retrained policy payload is loadable and carries norm stats
    assert final_policy != policy0 and os.path.exists(final_policy)
    net2, vars2, norm2 = load_policy(final_policy)
    assert norm2 is not None
    out = net2.apply(vars2, np.zeros((1, 47), np.float32), train=False)
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.slow
def test_ondevice_trained_policy_transfers_to_mujoco(go2, tmp_path):
    """sim-to-oracle closing of the flagship loop (VERDICT r2 item 1;
    reference protocol `DAgger/test/test_policy_rollout.py:41-55`): generate
    expert data ENTIRELY in the on-device jax_sim plant, BC-train a policy
    on it, then roll the CombinedController (policy + unsafe_v2 monitor +
    MPC expert) in the MuJoCo oracle for 5 s at 0.3 m/s. The rollout must
    survive, the policy must actually hold control beyond the mandated
    start window, and the rescued robot must make commanded progress."""
    import jax.numpy as jnp

    from iterative_learning_nmpc_tpu.learning.combined_controller import (
        CombinedController,
    )
    from iterative_learning_nmpc_tpu.learning.ondevice import (
        make_batched_mpc_rollout,
    )
    from iterative_learning_nmpc_tpu.learning.policy_controller import (
        PolicyController,
    )
    from iterative_learning_nmpc_tpu.learning.train import (
        BehavioralCloning,
        TrainConfig,
    )
    from iterative_learning_nmpc_tpu.models import dynamics as dyn
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu.sim.mujoco_sim import Simulator

    # --- on-device (jax_sim) expert datagen: NO MuJoCo data involved ---
    B, n_intervals = 8, 38  # 8 envs x 1.52 s
    rollout = make_batched_mpc_rollout(go2, n_intervals=n_intervals)
    q0 = np.asarray(go2.q_home, np.float32).copy()
    p0 = np.asarray(jax.jit(lambda q: dyn.foot_positions(go2, q))(q0))
    q0[2] += -p0[0, 2] + float(np.asarray(go2.foot_radius))
    x0 = np.concatenate([q0, np.zeros(18, np.float32)])
    rng = np.random.default_rng(0)
    x0b = np.tile(x0[None], (B, 1))
    x0b[:, 6:18] += rng.normal(0, 0.03, (B, 12)).astype(np.float32)
    vdes = np.zeros((B, 3), np.float32)
    vdes[:, 0] = 0.3
    out = rollout(jnp.asarray(x0b), jnp.asarray(vdes))
    T = out.q.shape[1]
    states = np.asarray(out.state44).reshape(-1, 44)
    actions = np.asarray(out.action).reshape(-1, 12)
    valid = np.asarray(out.valid).reshape(-1) > 0.5
    assert valid.mean() > 0.9  # the expert keeps the envs up in jax_sim

    db = Database(limit=len(states), goal_type="vc")
    db.append(states[valid], actions[valid],
              vc_goals=np.repeat(vdes, T, axis=0)[valid],
              traj_id=np.repeat(np.arange(B), T)[valid],
              times=np.tile(np.arange(T) * 1e-3, B)[valid])

    # --- BC training on the jax_sim data ---
    bc = BehavioralCloning(TrainConfig(
        hidden_dim=256, num_hidden_layer=2, n_epochs=60,
        batch_size=1024, save_dir=str(tmp_path), run_name="transfer"))
    policy_path = bc.run(db)
    assert bc.metrics[-1]["val_loss"] < 0.5 * bc.metrics[0]["val_loss"]

    # --- MuJoCo oracle rollout under the safety monitor ---
    v_des = np.array([0.3, 0.0, 0.0])
    sim = Simulator(go2)
    mpc = LocomotionMPC(go2, gait_name="trot", solve_async=False)
    pol = PolicyController(sim, policy_path, v_des=v_des)
    comb = CombinedController(sim, mpc, pol, v_des=v_des,
                              delay_steps=100, mpc_min_steps=1000)
    res = sim.run(sim_time=5.0, controller=comb)

    assert not res.fell and not res.diverged, res
    assert res.sim_time >= 5.0 - 1e-6
    modes = np.asarray(comb.mode_log, dtype=bool)
    # the policy held control beyond the mandated 100-step start window
    # (modes.any() is NOT asserted: a policy good enough to never trip the
    # monitor would be an even stronger pass)
    assert (~modes).sum() > 100, f"policy never in control: {modes.mean()}"
    # commanded progress under the combined controller (expert latched
    # tracks v_des thanks to construction-time set_command propagation)
    assert sim.data.qpos[0] > 0.3 * 0.3 * res.sim_time, sim.data.qpos[0]
    assert 0.2 < sim.data.qpos[2] < 0.4
