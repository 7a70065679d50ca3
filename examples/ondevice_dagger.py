"""Fully on-device LocoSafeDAgger CLI — the reference's iterative pipeline
(`DAgger/example/iter_locosafedagger.py`) with every data step running as B
parallel combined-controller rollouts on device (one compiled rollout for
all iterations; retrained weights enter as traced arguments).

    python examples/ondevice_dagger.py --policy ./policies/policy_bc_final.pkl \
        --batch 64 --sim_time 4 --iters 2 --out ./dagger_out
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", required=True, help="initial policy payload")
    ap.add_argument("--dataset", default=None,
                    help="optional initial HDF5 dataset to aggregate into")
    ap.add_argument("--robot", default="go2")
    ap.add_argument("--gait", default="trot")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sim_time", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=2,
                    help="DAgger iterations per goal")
    ap.add_argument("--goals", default="0.15,0,0;0,0,0;-0.15,0,0",
                    help="';'-separated vx,vy,wz goals")
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--delay_steps", type=int, default=100,
                    help="policy-only hysteresis delay (control steps)")
    ap.add_argument("--mpc_min_steps", type=int, default=2500,
                    help="expert latch length once engaged")
    ap.add_argument("--out", default="./dagger_out")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--randomize", action="store_true",
                    help="per-iteration payload/terrain randomization + "
                         "scheduled 50-70 N pushes on half the envs")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from run_mpc import get_spec

    from iterative_learning_nmpc_tpu.learning.dagger import (
        OnDeviceSafeDagger,
        SafeDaggerConfig,
    )

    goals = tuple(tuple(float(x) for x in g.split(","))
                  for g in args.goals.split(";"))
    cfg = SafeDaggerConfig(
        record_dir=args.out,
        sim_time=args.sim_time,
        gait_name=args.gait,
        n_epochs=args.epochs,
        goals=goals,
        n_iterations_per_goal=args.iters,
        delay_steps=args.delay_steps,
        mpc_min_steps=args.mpc_min_steps,
        seed=args.seed,
    )
    pipe = OnDeviceSafeDagger(get_spec(args.robot), cfg, args.policy,
                              initial_dataset=args.dataset,
                              batch=args.batch, randomize=args.randomize)
    t0 = time.time()
    final = pipe.run()
    print(f"done in {time.time() - t0:.1f}s wall")
    print(f"expert-influence ratios: "
          f"{[round(r, 3) for r in pipe.expert_ratio_history]}")
    print(f"final policy: {final}")
    print(f"final dataset: {pipe.dataset_path}")


if __name__ == "__main__":
    main()
