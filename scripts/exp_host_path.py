"""Host-MuJoCo data-path experiment (VERDICT r3 item 2).

The reference's core modality: collect force-perturbed MPC expert rollouts
IN THE PLANT (MuJoCo), train BC from scratch, and the checkpoint walks that
plant for seconds (`Behavior_Cloning/utils/data_collection_force_
perturbation.py:279-326`, `DAgger/test/test_policy_rollout.py:41-55`).
Every prior walking policy in this repo came from the jax_sim/on-device
path; this experiment produces one from host-MuJoCo data ONLY:

1. reference-scale DataCollection per goal (nominal 2 s + replanning-grid
   x perturbation force-perturbed rollouts, retry-until-no-fall),
2. merge the per-goal HDF5s,
3. BC train (L1/Adam, reference 47->512^3->12 BN net) from scratch,
4. pure-policy + combined MuJoCo eval at each goal.

    python scripts/exp_host_path.py --out /root/repo/.expr/host
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/root/repo/.expr/host")
    ap.add_argument("--goals", default="0.15,0.3")
    ap.add_argument("--n_perturb", type=int, default=10)
    ap.add_argument("--sim_time_nominal", type=float, default=2.0)
    ap.add_argument("--sim_time_perturbed", type=float, default=1.5)
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--eval_secs", type=float, default=5.0)
    ap.add_argument("--skip_collect", action="store_true")
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--policy", default=None, help="eval only")
    args = ap.parse_args()
    goals = [float(g) for g in args.goals.split(",")]

    import jax

    jax.config.update("jax_platforms", "cpu")
    from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
        setup_compile_cache,
    )

    setup_compile_cache()

    import numpy as np

    from iterative_learning_nmpc_tpu.learning.database import Database
    from iterative_learning_nmpc_tpu.learning.datagen import (
        DataCollection,
        DataCollectionConfig,
    )
    from iterative_learning_nmpc_tpu.learning.train import (
        BehavioralCloning,
        TrainConfig,
    )
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    spec = go2_spec()
    os.makedirs(args.out, exist_ok=True)

    # ---------------- per-goal reference-scale collection ----------------
    datasets = []
    for g in goals:
        gdir = os.path.join(args.out, f"collect_{g:+.2f}".replace("+", "p")
                            .replace("-", "m").replace(".", ""))
        datasets.append(gdir)
        if args.skip_collect or args.policy:
            continue
        cfg = DataCollectionConfig(
            record_dir=gdir,
            sim_time_nominal=args.sim_time_nominal,
            sim_time_perturbed=args.sim_time_perturbed,
            v_des=(g, 0.0, 0.0),
            num_perturbations_per_replanning=args.n_perturb,
            seed=int(g * 100) + 7,
        )
        t0 = time.time()
        out = DataCollection(spec, cfg).run()
        print(f"[collect vx={g}] -> {out} in {time.time()-t0:.0f}s",
              flush=True)

    # ---------------- merge + train ----------------
    final = args.policy or os.path.join(
        args.out, "policies", "policy_host_bc_final.pkl")
    if not (args.skip_train or args.policy):
        db = Database(limit=10_000_000, goal_type="vc")
        for gdir in datasets:
            h5s = [os.path.join(gdir, f) for f in sorted(os.listdir(gdir))
                   if f.endswith(".hdf5")]
            assert h5s, f"no dataset under {gdir}"
            db.load_saved_database(h5s[-1])  # append semantics
        print(f"[train] merged dataset: {len(db)} rows", flush=True)
        tc = TrainConfig(n_epochs=args.epochs, learning_rate=2e-3,
                         batch_size=1024,
                         save_dir=os.path.join(args.out, "policies"),
                         run_name="host_bc",
                         ckpt_every=max(args.epochs // 4, 1))
        bc = BehavioralCloning(tc)
        t0 = time.time()
        final = bc.run(db)
        m = bc.metrics[-1]
        print(f"[train] {args.epochs} epochs in {time.time()-t0:.0f}s "
              f"train={m['train_loss']:.4f} val={m['val_loss']:.4f}",
              flush=True)

    # ---------------- MuJoCo evals ----------------
    from iterative_learning_nmpc_tpu.learning.combined_controller import (
        CombinedController,
    )
    from iterative_learning_nmpc_tpu.learning.policy_controller import (
        PolicyController,
    )
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu.sim.mujoco_sim import Simulator

    for g in goals:
        v_des = np.array([g, 0.0, 0.0])
        sim = Simulator(spec)
        pol = PolicyController(sim, final, v_des=v_des)
        res = sim.run(sim_time=args.eval_secs, controller=pol)
        print(f"[mujoco pure] vx={g}: survived {res.sim_time:.2f}s "
              f"fell={res.fell} x={sim.data.qpos[0]:.2f} "
              f"z={sim.data.qpos[2]:.2f}", flush=True)

        sim2 = Simulator(spec)
        mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False)
        pol2 = PolicyController(sim2, final, v_des=v_des)
        comb = CombinedController(sim2, mpc, pol2, v_des=v_des,
                                  mpc_min_steps=1000)
        res2 = sim2.run(sim_time=args.eval_secs, controller=comb)
        ratio = float(np.mean(comb.mode_log)) if comb.mode_log else float("nan")
        print(f"[mujoco comb] vx={g}: survived {res2.sim_time:.2f}s "
              f"fell={res2.fell} x={sim2.data.qpos[0]:.2f} "
              f"expert_ratio={ratio:.2f}", flush=True)
    print(f"final policy: {final}", flush=True)


if __name__ == "__main__":
    main()
