"""Plant-scale data engine experiment: batched-expert MuJoCo collection
(learning/plant_batch.BatchedPlantCollector) -> balanced retrain -> robust
screen, iterated (SafeDAgger at scale IN the deployment plant).

Stage 1 seeds with expert-only force-perturbed noisy-start collects at the
full goal set (the BC DataCollection role at ~30x the single-env rate);
stage 2 runs combined-controller DAgger iterations with the current
policy. Every retrain balances goal bins and upweights plant rows against
the sim-curriculum base; every checkpoint gets the 3-start robust screen.

    python scripts/exp_plant_scale.py --out .expr/plant5
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOALS = (0.3, 0.15, 0.0, -0.15)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, ".expr", "plant5"))
    ap.add_argument("--n_envs", type=int, default=16)
    ap.add_argument("--sim_time", type=float, default=10.0)
    ap.add_argument("--expert_collects", type=int, default=3)
    ap.add_argument("--dagger_iters", type=int, default=4)
    ap.add_argument("--policy", default=os.path.join(
        REPO, ".expr", "distill5", "policies", "policy_bal_ep120.pkl"))
    ap.add_argument("--base_data", default=os.path.join(
        REPO, ".expr", "envelope", "stageE", "goal3_iter1",
        "agg_dataset.hdf5"))
    ap.add_argument("--inplant_weight", type=float, default=8.0)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--lr", type=float, default=5.0e-4)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
        setup_compile_cache,
    )

    setup_compile_cache()
    import numpy as np

    from iterative_learning_nmpc_tpu.learning.plant_batch import (
        BatchedPlantCollector,
    )
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    spec = go2_spec()
    os.makedirs(args.out, exist_ok=True)
    E = args.n_envs
    v_des = np.zeros((E, 3))
    v_des[:, 0] = np.tile(GOALS, E // len(GOALS) + 1)[:E]

    def save_rows(res, path):
        np.savez(path, state=res.state, action=res.action,
                 vc_goals=res.vc_goals, cc_goals=res.cc_goals,
                 time=res.time, is_expert=res.is_expert)
        print(f"[collect] {path}: {len(res.state)} rows, "
              f"{res.env_sim_s:.0f} env-sim-s in {res.wall_s:.0f}s wall "
              f"({res.env_sim_s / res.wall_s:.2f} env-sim-s/s), "
              f"fell {int(res.fell.sum())}/{E}, "
              f"expert_ratio {res.expert_ratio:.3f}", flush=True)

    py = sys.executable
    dag = os.path.join(REPO, "scripts", "exp_inplant_dagger.py")
    state_p = os.path.join(args.out, "state.json")
    st = (json.load(open(state_p)) if os.path.exists(state_p)
          else dict(stage1=0, trained1=False, dagger=0,
                    policy=args.policy, dataset=args.base_data,
                    base_rows=None))

    def save_state():
        with open(state_p, "w") as f:
            json.dump(st, f, indent=1)

    def retrain(tag, rows, warm, prev, base_rows):
        cmd = [py, dag, "train", "--prev", prev,
               "--out_h5", os.path.join(args.out, f"agg_{tag}.hdf5"),
               "--warm_start", warm,
               "--save_dir", os.path.join(args.out, "policies"),
               "--run_name", tag, "--epochs", str(args.epochs),
               "--lr", str(args.lr), "--batch_size", str(args.batch_size),
               "--device", "cpu", "--seed", str(args.seed),
               "--balance_goals",
               "--inplant_weight", str(args.inplant_weight),
               "--base_rows", str(base_rows),
               "--rows"] + rows
        log = os.path.join(args.out, f"train_{tag}.log")
        with open(log, "w") as lf:
            subprocess.run(cmd, stdout=lf, stderr=lf, check=True)
        final = None
        for line in open(log):
            if line.startswith("FINAL "):
                final = line.split(" ", 1)[1].strip()
        assert final, log
        return final, os.path.join(args.out, f"agg_{tag}.hdf5")

    def screen(policy, tag):
        oj = os.path.join(args.out, f"screen_{tag}.json")
        with open(os.path.join(args.out, f"screen_{tag}.log"), "w") as lf:
            subprocess.run([py, dag, "screen", "--policy", policy,
                            "--out_json", oj, "--n_starts", "3",
                            "--eval_secs", "5"],
                           stdout=lf, stderr=lf, check=True)
        r = json.load(open(oj))
        print(f"[screen] {tag}: {r['n_ok']}/4 " + " ".join(
            f"{g}:{r[str(g)]['n_pass']}/3" for g in GOALS), flush=True)
        return r

    # ---------------- stage 1: expert-only at scale ----------------
    coll = BatchedPlantCollector(spec, n_envs=E)
    rows1 = []
    for i in range(args.expert_collects):
        p = os.path.join(args.out, f"expert_{i}.npz")
        rows1.append(p)
        if i < st["stage1"]:
            continue
        res = coll.collect(v_des, sim_time=args.sim_time,
                           joint_noise=0.03, n_pushes=2,
                           seed=args.seed + 100 * i)
        save_rows(res, p)
        st["stage1"] = i + 1
        save_state()

    if not st["trained1"]:
        # base_rows = rows already in the base aggregate (sim curriculum)
        import h5py

        with h5py.File(args.base_data, "r") as f:
            nbase = len(f["states"])
        final, agg = retrain("s1", rows1, st["policy"], args.base_data,
                             nbase)
        st.update(policy=final, dataset=agg, trained1=True,
                  base_rows=nbase)
        save_state()
        screen(final, "s1")

    # ---------------- stage 2: combined DAgger at scale ----------------
    for it in range(st["dagger"], args.dagger_iters):
        coll_c = BatchedPlantCollector(spec, n_envs=E,
                                       policy_path=st["policy"])
        res = coll_c.collect(v_des, sim_time=args.sim_time,
                             joint_noise=0.03, n_pushes=1,
                             seed=args.seed + 1000 * (it + 1))
        p = os.path.join(args.out, f"dagger_{it}.npz")
        save_rows(res, p)
        final, agg = retrain(f"d{it}", [p], st["policy"], st["dataset"],
                             st["base_rows"])
        st.update(policy=final, dataset=agg, dagger=it + 1)
        save_state()
        screen(final, f"d{it}")
    print("[plant_scale] done; final policy", st["policy"], flush=True)


if __name__ == "__main__":
    main()
