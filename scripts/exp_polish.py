"""Polish loop: single DAgger iterations interleaved across the four goals
with a pure-MuJoCo 4-goal screen of EVERY retrained checkpoint; keeps the
checkpoint with the most goals passed. Checkpoint selection on the oracle
plant is the reference's own protocol (`DAgger/test/test_policy_rollout.py
:41-55` logs which checkpoints survive how long); round-4 screening showed
per-goal transfer is near-threshold and tips with each retrain, so the
search is over iterates, not a single final.

Screens run as CPU SUBPROCESSES (scripts/screen_checkpoints.py) overlapped
with the next device collect+train — the device never waits on MuJoCo.

    python scripts/exp_polish.py --init_policy ... --init_dataset ... \
        --out .expr/polish --rounds 14 --wide
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GOALS = (0.0, -0.15, 0.3, 0.15)
SCREEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "screen_checkpoints.py")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--init_policy", required=True)
    ap.add_argument("--init_dataset", required=True)
    ap.add_argument("--out", default="/root/repo/.expr/polish")
    ap.add_argument("--rounds", type=int, default=14)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sim_time", type=float, default=4.0)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=99)
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--target", type=int, default=4)
    args = ap.parse_args()

    import jax

    from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
        setup_compile_cache,
    )

    setup_compile_cache()

    from iterative_learning_nmpc_tpu.learning.dagger import (
        OnDeviceSafeDagger,
        SafeDaggerConfig,
    )
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    spec = go2_spec()
    os.makedirs(args.out, exist_ok=True)

    pending = []   # (proc, tag, policy_path, out_json)
    history = {}
    best = {"n_ok": -1, "path": None, "tag": None}

    def launch_screen(path, tag):
        out_json = os.path.join(args.out, f"screen_{tag}.json")
        log = open(os.path.join(args.out, f"screen_{tag}.log"), "w")
        p = subprocess.Popen(
            [sys.executable, SCREEN, "--glob", path, "--out", out_json],
            stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        pending.append((p, tag, path, out_json))

    def reap(block=False):
        done_any = False
        for item in list(pending):
            p, tag, path, out_json = item
            if block:
                p.wait()
            if p.poll() is None:
                continue
            pending.remove(item)
            done_any = True
            try:
                res = list(json.load(open(out_json)).values())[0]
            except Exception as e:
                print(f"[screen {tag}] FAILED to parse: {e}", flush=True)
                continue
            n_ok = res["n_ok"]
            history[tag] = dict(n_ok=n_ok, res=res, policy=path)
            print(f"[screen {tag}] {n_ok}/4 " + " ".join(
                f"{g}:{'OK' if res[str(g)]['ok'] else '--'}"
                f"(t={res[str(g)]['t']},x={res[str(g)]['x']:+.2f})"
                for g in GOALS), flush=True)
            if n_ok >= best["n_ok"]:
                best.update(n_ok=n_ok, path=path, tag=tag)
                shutil.copy(path, os.path.join(args.out, "policy_best.pkl"))
                print(f"[best] {n_ok}/4 {tag}", flush=True)
            with open(os.path.join(args.out, "history.json"), "w") as f:
                json.dump(history, f, indent=1)
        return done_any

    cfg = SafeDaggerConfig(
        record_dir=args.out, sim_time=args.sim_time, n_epochs=args.epochs,
        learning_rate=1e-3, batch_size=1024, mpc_min_steps=1000,
        goals=((0.0, 0.0, 0.0),), n_iterations_per_goal=1, seed=args.seed,
        x0_z_noise=0.02, x0_rpy_noise=0.05, x0_vel_noise=0.10,
        unsafe_height_bounds=(0.24, 0.40),
    )
    pk = dict(mass_range=(0.0, 4.0), com_shift=0.04) if args.wide else {}
    tk = dict(height_range=(-0.03, 0.03), stiffness_range=(0.8e4, 5.0e4),
              friction_range=(0.4, 1.1)) if args.wide else {}
    pipe = OnDeviceSafeDagger(
        spec, cfg, initial_policy=args.init_policy,
        initial_dataset=args.init_dataset, batch=args.batch,
        randomize=True, payload_kwargs=pk, terrain_kwargs=tk)

    for it in range(args.rounds):
        g = GOALS[it % len(GOALS)]
        tag = f"it{it:02d}_vx{g:+.2f}"
        t0 = time.time()
        pipe.dataset_path = pipe.collect(
            pipe.policy_path, (g, 0.0, 0.0), pipe.dataset_path, tag)
        pipe.policy_path = pipe.run_training(pipe.dataset_path, tag)
        print(f"[iter {tag}] collect+train {time.time()-t0:.0f}s "
              f"-> {pipe.policy_path}", flush=True)
        launch_screen(pipe.policy_path, tag)
        reap()
        if best["n_ok"] >= args.target:
            break
    while pending:
        reap(block=True)
    print(f"best: {best['n_ok']}/4 {best['tag']} -> {best['path']}",
          flush=True)


if __name__ == "__main__":
    main()
