"""Experiment: OnDeviceSafeDagger iterations -> MuJoCo transfer eval.

Continues scripts/exp_policy_transfer.py: starts from its BC policy +
dataset, runs the fully on-device SafeDAgger loop (jax_sim plant), then
evaluates the final policy pure and combined in BOTH jax_sim and MuJoCo.
"""
import argparse
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bc_dir", default="/tmp/transfer_v1")
    ap.add_argument("--out", default="/tmp/dagger_v1")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--sim_time", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--mpc_min_steps", type=int, default=1000)
    ap.add_argument("--goals", default="0.3,0.15",
                    help="comma-separated vx training goals (may be negative)")
    ap.add_argument("--eval_goals", default=None,
                    help="comma-separated vx eval goals (default: --goals)")
    ap.add_argument("--eval_secs", type=float, default=5.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--policy", default=None,
                    help="skip DAgger, evaluate this policy path")
    ap.add_argument("--randomize", action="store_true",
                    help="payload+terrain domain randomization per collect")
    ap.add_argument("--base_noise", type=float, default=0.0,
                    help="x0 base randomization scale: z std = 0.02*s, "
                         "pitch/roll std = 0.05*s rad, vel std = 0.1*s m/s")
    ap.add_argument("--tight_height", action="store_true",
                    help="tighten monitor height band to (0.24, 0.40) so the "
                         "expert relabels on height DRIFT, not just falls")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip_eval", action="store_true",
                    help="train only (evaluate later via --policy, e.g. in a "
                         "separate CPU process while the device trains on)")
    ap.add_argument("--init_policy", default=None,
                    help="override initial policy path (default: bc_dir BC)")
    ap.add_argument("--init_dataset", default=None,
                    help="override initial dataset (default: bc_dir data)")
    args = ap.parse_args()
    args.goals = [float(g) for g in args.goals.split(",")]
    args.eval_goals = ([float(g) for g in args.eval_goals.split(",")]
                       if args.eval_goals else list(args.goals))

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
        setup_compile_cache,
    )

    setup_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from iterative_learning_nmpc_tpu.learning.dagger import (
        OnDeviceSafeDagger,
        SafeDaggerConfig,
    )
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    spec = go2_spec()

    if args.policy is None:
        cfg = SafeDaggerConfig(
            record_dir=args.out,
            sim_time=args.sim_time,
            n_epochs=args.epochs,
            learning_rate=1e-3,
            batch_size=1024,
            mpc_min_steps=args.mpc_min_steps,
            goals=tuple((g, 0.0, 0.0) for g in args.goals),
            n_iterations_per_goal=args.iters,
            seed=args.seed,
            x0_z_noise=0.02 * args.base_noise,
            x0_rpy_noise=0.05 * args.base_noise,
            x0_vel_noise=0.10 * args.base_noise,
            unsafe_height_bounds=(0.24, 0.40) if args.tight_height else None,
        )
        pipe = OnDeviceSafeDagger(
            spec, cfg,
            initial_policy=args.init_policy or os.path.join(
                args.bc_dir, "policies", "policy_bc_final.pkl"),
            initial_dataset=args.init_dataset or os.path.join(
                args.bc_dir, "data.hdf5"),
            batch=args.batch, randomize=args.randomize)
        t0 = time.time()
        final = pipe.run()
        print(f"dagger: {len(pipe.expert_ratio_history)} iterations in "
              f"{time.time()-t0:.0f}s, expert ratios "
              f"{[round(r, 3) for r in pipe.expert_ratio_history]}")
    else:
        final = args.policy

    if args.skip_eval:
        print(f"final policy: {final}")
        return

    # ---------------- evaluations ----------------
    from iterative_learning_nmpc_tpu.learning.network import load_policy
    from iterative_learning_nmpc_tpu.learning.obs import policy_input  # noqa
    from iterative_learning_nmpc_tpu.sim import jax_sim
    from iterative_learning_nmpc_tpu.models import dynamics as dyn

    net, variables, norm = load_policy(final)
    mu_s, sd_s, mu_g, sd_g = [np.asarray(x, np.float32) for x in norm]
    sd_s = np.where(sd_s > 1e-8, sd_s, 1.0)

    q0 = np.asarray(spec.q_home, np.float32).copy()
    p0 = np.asarray(jax.jit(lambda q: dyn.foot_positions(spec, q))(q0))
    q0[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
    T = int(args.eval_secs * 1000)

    def apply_fn(x):
        s, g = x[:44], x[44:]
        s = s.at[1:].set((s[1:] - mu_s[1:]) / sd_s[1:])
        g = (g - mu_g) / sd_g
        return net.apply(variables, jnp.concatenate([s, g])[None],
                         train=False)[0]

    ro = jax_sim.make_batched_policy_rollout(spec, apply_fn, T)
    for vx in args.eval_goals:
        Q, V, fell = ro(jnp.asarray(q0)[None], jnp.zeros((1, 18)),
                        jnp.asarray([[vx, 0, 0]], jnp.float32))
        Q = np.asarray(Q[0])
        bad = (Q[:, 2] < 0.15) | (np.abs(Q[:, 4:6]).max(axis=1) > 0.6)
        tf = int(np.argmax(bad)) if bad.any() else T
        print(f"[jax_sim pure] vx={vx}: fell={bool(fell[0])} "
              f"t_fall={tf/1000:.2f}s x={Q[min(tf, T-1), 0]:.2f}", flush=True)

    from iterative_learning_nmpc_tpu.learning.combined_controller import (
        CombinedController,
    )
    from iterative_learning_nmpc_tpu.learning.policy_controller import (
        PolicyController,
    )
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu.sim.mujoco_sim import Simulator

    for vx in args.eval_goals:
        v_des = np.array([vx, 0.0, 0.0])
        sim = Simulator(spec)
        pol = PolicyController(sim, final, v_des=v_des)
        res = sim.run(sim_time=args.eval_secs, controller=pol)
        print(f"[mujoco pure] vx={vx}: survived {res.sim_time:.2f}s "
              f"fell={res.fell} x={sim.data.qpos[0]:.2f} "
              f"z={sim.data.qpos[2]:.2f}", flush=True)

        sim2 = Simulator(spec)
        mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False)
        pol2 = PolicyController(sim2, final, v_des=v_des)
        comb = CombinedController(sim2, mpc, pol2, v_des=v_des,
                                  mpc_min_steps=args.mpc_min_steps)
        res2 = sim2.run(sim_time=args.eval_secs, controller=comb)
        ratio = float(np.mean(comb.mode_log)) if comb.mode_log else float("nan")
        print(f"[mujoco comb] vx={vx}: survived {res2.sim_time:.2f}s "
              f"fell={res2.fell} x={sim2.data.qpos[0]:.2f} "
              f"expert_ratio={ratio:.2f}", flush=True)


if __name__ == "__main__":
    main()
