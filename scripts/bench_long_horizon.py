"""Long-horizon Riccati-mode comparison.

Times one full batched RTI step (linearize + sweep + rollout + AL epilogue)
at N=25 and N=100 for the sweep implementations:

  - triton      (fused sweep + rollout kernel; GPU only)
  - sequential  (lax.scan XLA sweep)
  - associative (log-depth parallel-in-time scan)

Run on a GPU host:   python scripts/bench_long_horizon.py --batch 256
(--cpu runs the XLA modes on the host CPU for a rehearsal). Writes
BENCH_HORIZON.json with the device it ran on.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--horizons", type=int, nargs="+", default=[25, 100])
    ap.add_argument("--modes", nargs="+",
                    default=["triton", "sequential", "associative"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from iterative_learning_nmpc_tpu.utils.compile_cache import (
        setup_compile_cache,
    )

    setup_compile_cache()

    import numpy as np

    from iterative_learning_nmpc_tpu.gait.planner import ContactPlanner
    from iterative_learning_nmpc_tpu.models import dynamics as dyn
    from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.solver.sqp import TrajOptSolver, make_params

    spec = go2_spec()
    B = args.batch
    print(f"backend={jax.default_backend()} device={jax.devices()[0]} B={B}")
    record = {}

    for N in args.horizons:
        gait, opt, cost = get_quadruped_config("trot", "go2")
        opt.n_nodes = N
        opt.time_horizon = N * 0.04
        planner = ContactPlanner(spec.feet_frame_names, 0.04, gait)
        q0 = np.asarray(spec.q_home, np.float32).copy()
        p0 = np.asarray(jax.jit(lambda qq: dyn.foot_positions(spec, qq))(q0))
        q0[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
        x0 = np.concatenate([q0, np.zeros(18, np.float32)])
        cnt = planner.get_contacts(0, N + 1).astype(np.float32)
        base_ref = np.zeros(12, np.float32)
        base_ref[:3] = q0[:3]
        base_ref[2] = gait.nom_height
        base_ref[6] = 0.3

        rows = {}
        for mode in args.modes:
            import copy

            o = copy.deepcopy(opt)
            o.riccati_mode = mode
            try:
                solver = TrajOptSolver(spec, o, cost)
            except Exception as e:
                rows[mode] = f"build failed: {e}"
                continue
            params = make_params(
                solver, x0, cnt, base_ref=base_ref, base_ref_e=base_ref,
                step_height=gait.step_height,
                ground_height=float(np.asarray(spec.foot_radius)))
            X, U = jax.jit(solver.cold_start)(params)
            pb = jax.tree.map(
                lambda t: np.broadcast_to(np.asarray(t)[None],
                                          (B,) + np.asarray(t).shape), params)
            Xb = np.broadcast_to(np.asarray(X)[None], (B,) + X.shape)
            Ub = np.broadcast_to(np.asarray(U)[None], (B,) + U.shape)

            step = jax.jit(jax.vmap(lambda x, u, p: solver.solve(x, u, p, 1).U))
            try:
                t0 = time.perf_counter()
                jax.block_until_ready(step(Xb, Ub, pb))
                compile_s = time.perf_counter() - t0
            except Exception as e:
                rows[mode] = f"compile failed: {type(e).__name__}: {e}"[:200]
                continue
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    out = step(Xb, Ub, pb)
                jax.block_until_ready(out)
                times.append((time.perf_counter() - t0) / args.reps)
            ms = float(np.median(times)) * 1e3
            rows[mode] = (f"{ms:8.1f} ms/step  ({B / (ms / 1e3):7.0f} "
                          f"solves/s, compile {compile_s:.0f}s)")
            record.setdefault(f"N{N}", {})[mode] = {
                "ms_per_batched_rti_step": round(ms, 1),
                "solves_per_s": round(B / (ms / 1e3), 0),
                "compile_s": round(compile_s, 0),
            }
        print(f"\nN={N}:")
        for mode, r in rows.items():
            print(f"  {mode:12s} {r}")
            if isinstance(r, str) and "failed" in r:
                record.setdefault(f"N{N}", {})[mode] = r

    import json

    record["what"] = "batched 1-RTI-step wall per Riccati mode"
    record["batch"] = B
    record["device"] = str(jax.devices()[0].device_kind)
    record["date"] = time.strftime("%Y-%m-%d")
    out_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "BENCH_HORIZON.json")
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
