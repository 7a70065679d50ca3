"""Balanced single-policy distillation from a multi-goal aggregate
(VERDICT r4 item 5): train ONE net on the full curriculum aggregate with
PER-GOAL-BALANCED batch sampling (the measured interference mitigation —
round-4's unbalanced distill specialized to one goal per run), checkpoint
on a cadence, then robust-screen every checkpoint (perturbed starts) at
the 4-goal envelope and report the best.

    python scripts/exp_balanced_distill.py --data <agg.hdf5> --out .expr/distill5
"""
import argparse
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", default=os.path.join(REPO, ".expr", "distill5"))
    ap.add_argument("--epochs", type=int, default=240)
    ap.add_argument("--ckpt_every", type=int, default=24)
    ap.add_argument("--lr", type=float, default=2.0e-3)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--warm_start", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
        setup_compile_cache,
    )

    setup_compile_cache()
    import numpy as np

    from iterative_learning_nmpc_tpu.learning.database import Database
    from iterative_learning_nmpc_tpu.learning.train import (
        BehavioralCloning,
        TrainConfig,
    )

    os.makedirs(args.out, exist_ok=True)
    if not args.skip_train:
        db = Database(limit=10_000_000, goal_type="vc")
        t0 = time.time()
        db.load_saved_database(args.data)
        print(f"[distill] {len(db)} rows loaded in {time.time()-t0:.0f}s",
              flush=True)
        vx = db.goals_array()[:, 0]
        bins = np.round(vx / 0.05).astype(int)
        uniq, inv, cnt = np.unique(bins, return_inverse=True,
                                   return_counts=True)
        weights = 1.0 / cnt[inv]
        print(f"[distill] vx bins {0.05 * uniq} rows {cnt}", flush=True)

        tc = TrainConfig(
            learning_rate=args.lr, batch_size=args.batch_size,
            n_epochs=args.epochs, ckpt_every=args.ckpt_every,
            save_dir=os.path.join(args.out, "policies"),
            run_name="bal", seed=args.seed,
        )
        bc = BehavioralCloning(tc)
        t0 = time.time()
        final = bc.run(db, warm_start_path=args.warm_start,
                       sample_weights=weights)
        m = bc.metrics[-1]
        print(f"[distill] {args.epochs} epochs in {time.time()-t0:.0f}s "
              f"train={m['train_loss']:.4f} val={m['val_loss']:.4f} "
              f"-> {final}", flush=True)

    # robust-screen every checkpoint (subprocesses, CPU)
    paths = sorted(glob.glob(os.path.join(args.out, "policies", "*.pkl")))
    me = os.path.join(REPO, "scripts", "exp_inplant_dagger.py")
    results = {}
    for p in paths:
        oj = p + ".screen.json"
        subprocess.run([sys.executable, me, "screen", "--policy", p,
                        "--out_json", oj, "--n_starts", "3",
                        "--eval_secs", "5"],
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        with open(oj) as f:
            r = json.load(f)
        results[os.path.basename(p)] = r
        print(f"[screen] {os.path.basename(p)}: {r['n_ok']}/4 "
              + " ".join(f"{g}:{r[g]['n_pass']}/3"
                         for g in ("0.3", "0.15", "0.0", "-0.15")),
              flush=True)
    best = max(results.items(),
               key=lambda kv: (kv[1]["n_ok"],
                               sum(kv[1][g]["n_pass"]
                                   for g in ("0.3", "0.15", "0.0", "-0.15"))))
    print(f"[distill] BEST {best[0]} robust {best[1]['n_ok']}/4", flush=True)
    with open(os.path.join(args.out, "screen_results.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
