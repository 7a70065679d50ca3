"""Screen every envelope-curriculum checkpoint: pure-MuJoCo 5 s survival
at the four target goals. Prints one line per (policy, goal) and a final
JSON of per-policy results.

    python scripts/screen_checkpoints.py --glob '.expr/envelope/*/policies/*_final.pkl' \
        [--shard 0/3]
"""
import argparse
import glob as globmod
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GOALS = (0.3, 0.15, 0.0, -0.15)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--glob", default=".expr/envelope/*/policies/*_final.pkl")
    ap.add_argument("--eval_secs", type=float, default=5.0)
    ap.add_argument("--shard", default="0/1")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    i, n = map(int, args.shard.split("/"))

    import jax

    jax.config.update("jax_platforms", "cpu")
    from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
        setup_compile_cache,
    )

    setup_compile_cache()
    import numpy as np

    from iterative_learning_nmpc_tpu.learning.policy_controller import (
        PolicyController,
    )
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.sim.mujoco_sim import Simulator

    spec = go2_spec()
    paths = sorted(globmod.glob(args.glob))[i::n]
    results = {}
    for p in paths:
        tag = "/".join(p.split(os.sep)[-3:])
        res = {}
        for g in GOALS:
            sim = Simulator(spec)
            pol = PolicyController(sim, p, v_des=np.array([g, 0.0, 0.0]))
            r = sim.run(sim_time=args.eval_secs, controller=pol)
            x = float(sim.data.qpos[0])
            ok = (not r.fell) and r.sim_time >= args.eval_secs - 1e-6
            # "walks" = survives AND makes commanded-direction progress
            # (>=40% of commanded displacement; stand for g=0 = low drift)
            if g != 0.0:
                ok = ok and (np.sign(x) == np.sign(g)
                             and abs(x) >= 0.4 * abs(g) * args.eval_secs)
            else:
                ok = ok and abs(x) < 0.5
            res[g] = dict(t=round(r.sim_time, 2), x=round(x, 2), ok=bool(ok))
            print(f"{tag} vx={g:+.2f}: t={r.sim_time:.2f} x={x:+.2f} "
                  f"{'OK' if ok else '--'}", flush=True)
        res["n_ok"] = sum(1 for g in GOALS if res[g]["ok"])
        results[tag] = res
    best = sorted(results.items(), key=lambda kv: -kv[1]["n_ok"])
    print("\n=== ranking ===")
    for tag, r in best[:10]:
        print(f"{r['n_ok']}/4 {tag} " + " ".join(
            f"{g:+.2f}:{'OK' if r[g]['ok'] else '--'}" for g in GOALS))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
