"""Experiment: on-device (jax_sim) expert datagen + BC training -> MuJoCo.

Calibrates the DAgger/BC -> MuJoCo transfer test (VERDICT r2 item 1): how
much on-device data / training does a policy need before it survives in the
MuJoCo oracle plant?

    python scripts/exp_policy_transfer.py --batch 64 --seconds 2 \
        --epochs 150 [--cpu]
"""
import argparse
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--joint_noise", type=float, default=0.03)
    ap.add_argument("--vx_lo", type=float, default=0.1)
    ap.add_argument("--vx_hi", type=float, default=0.35)
    ap.add_argument("--vy", type=float, default=0.05)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval_vx", type=float, nargs="+", default=[0.15, 0.3])
    ap.add_argument("--eval_secs", type=float, default=5.0)
    ap.add_argument("--out", default="/tmp/transfer_exp")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip_datagen", action="store_true",
                    help="reuse --out/data.hdf5 from a previous run")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse --out/policies/policy_bc_final.pkl")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
        setup_compile_cache,
    )

    setup_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from iterative_learning_nmpc_tpu.learning.database import Database
    from iterative_learning_nmpc_tpu.learning.ondevice import (
        make_batched_mpc_rollout,
    )
    from iterative_learning_nmpc_tpu.learning.train import (
        BehavioralCloning,
        TrainConfig,
    )
    from iterative_learning_nmpc_tpu.models import dynamics as dyn
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    spec = go2_spec()
    os.makedirs(args.out, exist_ok=True)
    data_path = os.path.join(args.out, "data.hdf5")

    # ---------------- datagen (on-device expert rollouts) ----------------
    if not args.skip_datagen:
        q0 = np.asarray(spec.q_home, np.float32).copy()
        p0 = np.asarray(jax.jit(lambda q: dyn.foot_positions(spec, q))(q0))
        q0[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
        x0 = np.concatenate([q0, np.zeros(18, np.float32)])

        rng = np.random.default_rng(0)
        B = args.batch
        x0b = np.tile(x0[None], (B, 1))
        x0b[:, 6:18] += rng.normal(0, args.joint_noise, (B, 12)).astype(np.float32)
        vdes = np.zeros((B, 3), np.float32)
        vdes[:, 0] = rng.uniform(args.vx_lo, args.vx_hi, B)
        vdes[:, 1] = rng.uniform(-args.vy, args.vy, B)

        n_intervals = int(round(args.seconds / 0.04))
        rollout = make_batched_mpc_rollout(spec, n_intervals=n_intervals)
        t0 = time.time()
        out = rollout(jnp.asarray(x0b), jnp.asarray(vdes))
        jax.block_until_ready(out.q)
        T = out.q.shape[1]
        print(f"datagen: {B} envs x {args.seconds}s in {time.time()-t0:.1f}s")

        states = np.asarray(out.state44).reshape(-1, 44)
        actions = np.asarray(out.action).reshape(-1, 12)
        valid = np.asarray(out.valid).reshape(-1) > 0.5
        goals = np.repeat(vdes, T, axis=0)
        traj_ids = np.repeat(np.arange(B), T)
        times = np.tile(np.arange(T) * 1e-3, B)
        db = Database(limit=max(int(valid.sum()), 1), goal_type="vc")
        db.append(states[valid], actions[valid], vc_goals=goals[valid],
                  traj_id=traj_ids[valid], times=times[valid])
        db.save_as_hdf5(data_path)
        print(f"dataset: {len(db)} rows ({valid.mean():.1%} valid)")
    else:
        db = Database(limit=10**7, goal_type="vc")
        db.load_saved_database(data_path)
        print(f"loaded dataset: {len(db)} rows")

    # ---------------- training ----------------
    pol_dir = os.path.join(args.out, "policies")
    final = os.path.join(pol_dir, "policy_bc_final.pkl")
    if not args.skip_train:
        cfg = TrainConfig(
            hidden_dim=args.hidden, num_hidden_layer=args.layers,
            n_epochs=args.epochs, learning_rate=args.lr,
            save_dir=pol_dir, run_name="bc", ckpt_every=max(args.epochs // 3, 1))
        bc = BehavioralCloning(cfg)
        t0 = time.time()
        final = bc.run(db)
        m = bc.metrics[-1]
        print(f"train: {args.epochs} epochs in {time.time()-t0:.1f}s  "
              f"train_loss={m['train_loss']:.4f} val_loss={m['val_loss']:.4f}")

    # ---------------- MuJoCo evaluation ----------------
    from iterative_learning_nmpc_tpu.learning.combined_controller import (
        CombinedController,
    )
    from iterative_learning_nmpc_tpu.learning.policy_controller import (
        PolicyController,
    )
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu.sim.mujoco_sim import Simulator

    for vx in args.eval_vx:
        v_des = np.array([vx, 0.0, 0.0])
        # pure policy rollout
        sim = Simulator(spec)
        pol = PolicyController(sim, final, v_des=v_des)
        res = sim.run(sim_time=args.eval_secs, controller=pol)
        prog = sim.data.qpos[0]
        print(f"[pure policy] vx={vx}: survived {res.sim_time:.2f}s "
              f"fell={res.fell} x={prog:.2f} ({prog/max(res.sim_time,1e-6):.2f} m/s)"
              f" z={sim.data.qpos[2]:.2f}")

        # combined (safety monitor + MPC fallback)
        sim2 = Simulator(spec)
        mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False)
        pol2 = PolicyController(sim2, final, v_des=v_des)
        comb = CombinedController(sim2, mpc, pol2, v_des=v_des)
        res2 = sim2.run(sim_time=args.eval_secs, controller=comb)
        ratio = float(np.mean(comb.mode_log)) if comb.mode_log else float("nan")
        print(f"[combined]    vx={vx}: survived {res2.sim_time:.2f}s "
              f"fell={res2.fell} x={sim2.data.qpos[0]:.2f} "
              f"expert_ratio={ratio:.2f}")


if __name__ == "__main__":
    main()
