"""Batched-expert plant collection CLI: many MuJoCo envs, one vmapped device
replan (learning/plant_batch.BatchedPlantCollector).

The scale form of the reference's data generation
(`Behavior_Cloning/utils/data_collection_force_perturbation.py` /
`DAgger/utils/data_collection_locosafedagger.py`): expert-only
force-perturbed rollouts for BC datasets, or combined-controller rollouts
with is_expert labels for SafeDAgger aggregation. Writes recorder-contract
rows to an npz plus an HDF5 Database snapshot.

    # 160 env-sim-s of expert demonstrations across the velocity goals:
    python examples/collect_plant_batch.py --out ./plant_data

    # SafeDAgger data step with a learned policy driving:
    python examples/collect_plant_batch.py --out ./plant_data \
        --policy assets/policy_go2_trot_inplant_dagger.pkl
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="./plant_data")
    ap.add_argument("--robot", default="go2", choices=("go2", "solo12"))
    ap.add_argument("--gait", default="trot")
    ap.add_argument("--n_envs", type=int, default=16)
    ap.add_argument("--sim_time", type=float, default=10.0)
    ap.add_argument("--goals", default="0.3,0.15,0.0,-0.15",
                    help="vx goals cycled over the envs")
    ap.add_argument("--policy", default=None,
                    help="combined mode: policy drives, expert relabels")
    ap.add_argument("--joint_noise", type=float, default=0.03)
    ap.add_argument("--n_pushes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from iterative_learning_nmpc_tpu.learning.database import Database
    from iterative_learning_nmpc_tpu.utils.compile_cache import (
        setup_compile_cache,
    )
    from iterative_learning_nmpc_tpu.learning.plant_batch import (
        BatchedPlantCollector,
    )
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.robots.solo12 import solo12_spec

    setup_compile_cache()
    spec = go2_spec() if args.robot == "go2" else solo12_spec()
    goals = [float(g) for g in args.goals.split(",")]
    E = args.n_envs
    v_des = np.zeros((E, 3))
    v_des[:, 0] = np.tile(goals, E // len(goals) + 1)[:E]

    coll = BatchedPlantCollector(spec, n_envs=E, gait_name=args.gait,
                                 policy_path=args.policy)
    res = coll.collect(v_des, sim_time=args.sim_time,
                       joint_noise=args.joint_noise,
                       n_pushes=args.n_pushes, seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    npz = os.path.join(args.out, "plant_rows.npz")
    np.savez(npz, state=res.state, action=res.action,
             vc_goals=res.vc_goals, cc_goals=res.cc_goals, time=res.time,
             env_id=res.env_id, is_expert=res.is_expert)

    db = Database(limit=10_000_000, goal_type="vc")
    keep = res.is_expert.astype(bool)  # expert-labeled rows only (DAgger)
    db.append(res.state[keep], res.action[keep],
              vc_goals=res.vc_goals[keep], cc_goals=res.cc_goals[keep],
              traj_id=res.env_id[keep], times=res.time[keep])
    h5 = os.path.join(args.out, "database_plant.hdf5")
    db.save_as_hdf5(h5, config=vars(args))
    print(f"collected {len(res.state)} rows ({int(keep.sum())} expert) "
          f"over {res.env_sim_s:.0f} env-sim-s in {res.wall_s:.0f}s "
          f"({res.env_sim_s / res.wall_s:.2f} env-sim-s/s); "
          f"fell {int(res.fell.sum())}/{E}; "
          f"expert ratio {res.expert_ratio:.3f}\n-> {npz}\n-> {h5}")


if __name__ == "__main__":
    main()
