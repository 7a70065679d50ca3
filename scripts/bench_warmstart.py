"""Measure cold-boot inits on the solver -> BENCH_WARMSTART.json.

BASELINE.json north star: "learned-policy warm-starts feed back into the
solver to cut iterations". Round-5 closure: the measured value decomposes
into (a) the initial (X, U) guess — where the engineered stationary
cold_start wins against every policy rollout — and (b) the GAIT-PHASE
OFFSET of the contact schedule, which a cold boot is free to choose and
which moves the converged solution up to 24% on perturbed states.
`merit_phase_boot` (the production LocomotionMPC cold-boot path) picks it
with one vmapped 3-iteration probe.

Uses the SHIPPED artifact (assets/policy_go2_trot_ondevice_dagger.pkl) on
three start states (home stand, perturbed mid-gait, post-divergence
recovery), five inits:

- naive:        x0-replicated states + zero inputs (acados-style)
- cold:         solver.cold_start at the fixed offset-0 schedule
- policy:       solver/warmstart.policy_warmstart (device-plant rollout,
                offset-0 schedule) — the round-4 path
- policy_match: phase_aligned_warmstart (rollout + contact-pattern offset
                pick) — the learned phase-alignment variant
- merit_boot:   merit_phase_boot offset pick + engineered cold start —
                the production path

Reports iterations-to-nlp_tol (SolveStats.sqp_iters), final GN cost, the
probe's offset pick vs the true best offset (15-iteration vmapped sweep),
and full cold-boot latency (init + 15-iteration solve, ONE device call).

    python scripts/bench_warmstart.py [--cpu] [--out BENCH_WARMSTART.json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "BENCH_WARMSTART.json"))
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
        setup_compile_cache,
    )

    setup_compile_cache()

    import dataclasses as dc

    import jax.numpy as jnp
    import numpy as np

    from iterative_learning_nmpc_tpu.gait.planner import ContactPlanner
    from iterative_learning_nmpc_tpu.learning.network import make_policy_apply
    from iterative_learning_nmpc_tpu.models import dynamics as dyn
    from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.solver.sqp import TrajOptSolver, make_params
    from iterative_learning_nmpc_tpu.solver.warmstart import (
        contact_windows,
        merit_phase_boot,
        phase_aligned_warmstart,
        policy_warmstart,
    )

    spec = go2_spec()
    gait, opt, cost = get_quadruped_config("trot", "go2")
    solver = TrajOptSolver(spec, opt, cost)
    N = solver.N
    planner = ContactPlanner(spec.feet_frame_names, solver.dt_nodes, gait)
    W = jnp.asarray(contact_windows(planner, N))

    apply_fn = make_policy_apply(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "policy_go2_trot_ondevice_dagger.pkl"))

    q0 = np.asarray(spec.q_home, np.float32).copy()
    p0 = np.asarray(jax.jit(lambda q: dyn.foot_positions(spec, q))(q0))
    q0[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
    v_des = np.array([0.3, 0.0, 0.0], np.float32)

    states = {"home": np.concatenate([q0, np.zeros(18, np.float32)])}
    qs = q0.copy()
    qs[2] -= 0.02
    qs[6:18] += np.random.default_rng(1).normal(0, 0.05, 12).astype(np.float32)
    vs = np.zeros(18, np.float32)
    vs[0] = 0.3
    states["midgait"] = np.concatenate([qs, vs])
    qr = q0.copy()
    qr[2] -= 0.06
    qr[4] = 0.15
    qr[5] = -0.1
    vr = np.zeros(18, np.float32)
    vr[[0, 1, 2]] = (0.1, -0.2, -0.3)
    states["recovery"] = np.concatenate([qr, vr])

    solve = jax.jit(lambda X, U, p, n: solver.solve(X, U, p, n),
                    static_argnums=3)
    cold = jax.jit(solver.cold_start)
    ws = jax.jit(lambda p: policy_warmstart(solver, apply_fn, p, v_des))
    ws_match = jax.jit(
        lambda p: phase_aligned_warmstart(solver, apply_fn, p, v_des, W))
    boot = jax.jit(lambda p: merit_phase_boot(solver, p, W))

    def full_cost(p, w):
        p2 = dc.replace(p, cnt=w, peak=1.0 - w)
        X, U = solver.cold_start(p2)
        s = solver.solve(X, U, p2, 15)
        return s.stats.cost

    vm_full = jax.jit(jax.vmap(full_cost, in_axes=(None, 0)))

    # fused cold-boot paths for latency (ONE device call each)
    @jax.jit
    def boot_cold(p):
        X, U = solver.cold_start(p)
        return solver.solve(X, U, p, 15).X

    @jax.jit
    def boot_policy(p):
        X, U = policy_warmstart(solver, apply_fn, p, v_des)
        return solver.solve(X, U, p, 15).X

    @jax.jit
    def boot_merit(p):
        p2, off, _ = merit_phase_boot(solver, p, W)
        X, U = solver.cold_start(p2)
        return solver.solve(X, U, p2, 15).X

    def timeit(fn, p):
        jax.block_until_ready(fn(p))  # compile
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            jax.block_until_ready(fn(p))
        return (time.perf_counter() - t0) / args.repeats * 1e3

    table = {}
    for name, x0 in states.items():
        cnt = planner.get_contacts(0, N + 1)
        base_ref = np.zeros(12, np.float32)
        base_ref[:3] = x0[:3]
        base_ref[2] = gait.nom_height
        base_ref[6] = v_des[0]
        p = make_params(solver, x0, cnt, base_ref=base_ref,
                        step_height=gait.step_height)
        Xn = jnp.tile(jnp.asarray(x0)[None], (N + 1, 1))
        Un = jnp.zeros((N, 30), jnp.float32)
        sn = solve(Xn, Un, p, 15)
        Xc, Uc = cold(p)
        sc = solve(Xc, Uc, p, 15)
        Xw, Uw = ws(p)
        sw = solve(Xw, Uw, p, 15)
        Xm, Um, pm, offm = ws_match(p)
        sm = solve(Xm, Um, pm, 15)
        pb, offb, _ = boot(p)
        Xb, Ub = jax.jit(solver.cold_start)(pb)
        sb = solve(Xb, Ub, pb, 15)
        truth = np.asarray(vm_full(p, W))
        table[name] = {
            "naive": {"iters": int(sn.stats.sqp_iters),
                      "cost": round(float(sn.stats.cost), 2)},
            "cold": {"iters": int(sc.stats.sqp_iters),
                     "cost": round(float(sc.stats.cost), 2)},
            "policy": {"iters": int(sw.stats.sqp_iters),
                       "cost": round(float(sw.stats.cost), 2)},
            "policy_match": {"iters": int(sm.stats.sqp_iters),
                             "cost": round(float(sm.stats.cost), 2),
                             "offset": int(offm)},
            "merit_boot": {"iters": int(sb.stats.sqp_iters),
                           "cost": round(float(sb.stats.cost), 2),
                           "offset": int(offb)},
            "true_best_offset": int(truth.argmin()),
            "offset_cost_range": [round(float(truth.min()), 1),
                                  round(float(truth.max()), 1)],
            "boot_latency_ms": {
                "cold": round(timeit(boot_cold, p), 3),
                "policy": round(timeit(boot_policy, p), 3),
                "merit": round(timeit(boot_merit, p), 3),
            },
        }
        print(name, json.dumps(table[name]), flush=True)

    out = {
        "what": ("cold-boot init comparison with the shipped DAgger "
                 "artifact: acados-style naive, engineered cold_start, "
                 "policy rollout (offset 0), policy rollout + contact-"
                 "pattern offset pick, and the production merit_phase_boot "
                 "(vmapped 3-iter probe over all gait-phase offsets); "
                 "iterations to nlp_tol + 15-iter cold-boot latency"),
        "hardware": jax.devices()[0].device_kind,
        "artifact": "assets/policy_go2_trot_ondevice_dagger.pkl",
        "nlp_tol": float(opt.nlp_tol),
        "repeats": args.repeats,
        "states": table,
        "date": time.strftime("%Y-%m-%d"),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
