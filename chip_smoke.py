"""Start-up proof on the GPU: the NMPC expert and its learning loop, end to end.

    python chip_smoke.py            # one GPU: phases 0-5
    python chip_smoke.py --four     # four GPUs: the dp mesh path only

Phases (each prints one line of results; any failed check raises and the
script exits non-zero — no phase catches its own failure):

0. device guard: JAX's default backend must be "gpu" (exit 2 otherwise);
   prints the device, the jax/jaxlib versions, XLA_FLAGS and nvidia-smi's
   name and power limit.
1. batched RTI at B=512, N=25 (Go2 trot, 36 states, 30 inputs) through
   `__graft_entry__._flagship` and `TrajOptSolver.solve`: a 15-iteration
   cold converge, then a device-chained warm RTI chain with dual carry-over.
   Parity against the CPU oracle (sequential Riccati + jacfwd) <= 1e-3 for
   the converged solve and one RTI step; converged cost within
   BENCH_ANCHOR.json's band. Reports solves/s, compile seconds and the
   linearize / Riccati stage times.
2. one-robot replans through `LocomotionMPC` (no MuJoCo): first solve, then
   >= 20 RTI replans; p50/p99 latency; first-solve U vs the CPU oracle.
3. batched expert rollout (`make_batched_mpc_rollout`) on `sim/jax_sim`:
   512 envs x 2 replan intervals; finite outputs, base height in
   [0.18, 0.45].
4. BC training at the reference width (47 -> 512x3 -> 12, batch norm, L1,
   Adam, batch 1024): >= 20 steps of `BehavioralCloning`'s jitted epoch
   scan on synthetic rows from --seed; loss finite and decreasing; the
   shipped policy's device forward pass vs the float64 numpy forward.
5. the Triton Riccati kernel vs the XLA sweep at B=512, N in {25, 100}
   (K, kff, dX1, dU1 within 1e-4), and the device-chained B=512 RTI step
   time with and without the kernel (median of 5 runs each, alternating,
   in this process).

The CPU oracles run in one worker thread of this process while the GPU
compiles; nothing else opens the GPU.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
import argparse
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402

ANCHOR = os.path.join(ROOT, "BENCH_ANCHOR.json")
POLICY = os.path.join(ROOT, "assets", "policy_go2_trot_inplant_dagger.pkl")
PARITY_TOL = 1e-3
KERNEL_TOL = 1e-4
POLICY_TOL = 1e-4


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def report(phase, **vals):
    items = " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in vals.items())
    print(f"[phase {phase}] {items}", flush=True)


def on_cpu(fn, *args):
    """Run a jitted fn on the host CPU (the oracle)."""
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        args = jax.tree.map(np.asarray, args)
        return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def cpu_oracle():
    from bench import _cpu_solver

    return _cpu_solver("trot")


# ---------------------------------------------------------------- phase 1
def phase1_batched_rti(seed, pool, batch=512, reps=20):
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship
    from bench import _rti_chain
    from profile_rti import batch_inputs, stage_times
    from iterative_learning_nmpc_tpu.utils.device import rel_err

    solver, X, U, params = _flagship()
    oracle = cpu_oracle()
    # CPU reference of the converged solve compiles while the device works
    conv_cpu = pool.submit(
        on_cpu, lambda x, u, p: oracle.solve(x, u, p, 15), X, U, params)
    Xb, Ub, pb = batch_inputs(solver, X, U, params, batch, seed)
    conv = jax.jit(jax.vmap(lambda x, u, p: solver.solve(x, u, p, 15)))
    sol = jax.block_until_ready(conv(Xb, Ub, pb))

    # one warm RTI step from the device's converged batch; row 0 vs oracle
    pc = dataclasses.replace(pb, lam_ineq=sol.lam_ineq)
    p1 = jax.tree.map(lambda x: np.asarray(x)[0], pc)
    rti_cpu = pool.submit(on_cpu, lambda x, u, p: oracle.solve(x, u, p, 1),
                          sol.X[0], sol.U[0], p1)
    rti = jax.jit(jax.vmap(lambda x, u, p: solver.solve(x, u, p, 1)))
    s1 = jax.block_until_ready(rti(sol.X, sol.U, pc))

    # device-chained warm RTI with dual carry-over (bench.py regime)
    chain = jax.jit(jax.vmap(_rti_chain(solver, reps)))
    lam0 = jnp.zeros((batch, solver.N, 18), jnp.float32)
    args = (sol.X, sol.U, lam0, sol.lam_ineq, pb)
    t0 = time.perf_counter()
    compiled = chain.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        (Xo, Uo, _, _), cost, _ = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    check(np.isfinite(np.asarray(Uo)).all() and np.isfinite(
        np.asarray(cost)).all(), "RTI chain produced non-finite values")
    stages = stage_times(solver, sol.X, sol.U, pc, rti=rti)

    s_cpu, s1_cpu = conv_cpu.result(), rti_cpu.result()
    conv_rel = rel_err(sol.U[0], s_cpu.U)
    rti_rel = rel_err(s1.U[0], s1_cpu.U)
    with open(ANCHOR) as f:
        anchor = json.load(f)
    ref, tol = float(anchor["converged_cost_cpu"]), float(anchor["tol_rel"])
    cost_dev = float(sol.stats.cost[0])
    cost_cpu = float(s_cpu.stats.cost)
    report(1, batch=batch, N=solver.N, riccati_mode=solver._riccati_mode,
           solves_per_s=batch * reps / dt, chain_compile_s=compile_s,
           chain_step_ms=dt / reps * 1e3, **stages,
           parity_conv=conv_rel, parity_rti=rti_rel, cost_dev=cost_dev,
           cost_cpu=cost_cpu, anchor=ref)
    check(conv_rel <= PARITY_TOL, f"converged parity {conv_rel:.3e}")
    check(rti_rel <= PARITY_TOL, f"RTI parity {rti_rel:.3e}")
    check(abs(cost_dev / ref - 1.0) <= tol and abs(cost_cpu / ref - 1.0) <= tol,
          f"cost anchor: device {cost_dev}, cpu {cost_cpu}, anchor {ref}")
    return solver, compiled, args, reps


# ---------------------------------------------------------------- phase 2
def _home_state(spec):
    import jax

    from iterative_learning_nmpc_tpu.models import dynamics as dyn

    q = np.asarray(spec.q_home, np.float64).copy()
    p0 = np.asarray(jax.jit(lambda qq: dyn.foot_positions(spec, qq))(
        q.astype(np.float32)))
    q[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
    return q, np.zeros(spec.nv)


def _make_mpc(spec):
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC

    m = LocomotionMPC(spec, "trot", solve_async=False, compute_timings=False,
                      phase_aligned_boot=False)
    m.set_command(np.array([0.3, 0.0, 0.0]))
    return m


def replan_oracle():
    """First-solve U of the same controller on the CPU (sequential sweep)."""
    import jax

    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    with jax.default_device(jax.devices("cpu")[0]):
        spec = go2_spec()
        q, v = _home_state(spec)
        ref = _make_mpc(spec)
        ref.solver._riccati_mode = "sequential"
        ref.optimize(q, v)
        return np.asarray(ref._U_prev)


def phase2_replans(oracle, n_replans=24):
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.utils.device import rel_err

    spec = go2_spec()
    q, v = _home_state(spec)
    mpc = _make_mpc(spec)
    t0 = time.perf_counter()
    mpc.optimize(q, v)
    first_s = time.perf_counter() - t0
    U_first = np.asarray(mpc._U_prev)
    mpc.first_solve = False
    lat = []
    for _ in range(n_replans + 2):
        mpc.current_opt_node += 1      # one node per 25 Hz replan
        t0 = time.perf_counter()
        plan = mpc.optimize(q, v)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat[2:])          # the first steady call compiles
    check(all(np.isfinite(x).all() for x in plan), "non-finite replan")
    first_rel = rel_err(U_first, oracle.result())
    report(2, replans=len(lat), p50_ms=float(np.percentile(lat, 50)),
           p99_ms=float(np.percentile(lat, 99)),
           max_ms=float(lat.max()), first_solve_s_incl_compile=first_s,
           parity_first=first_rel)
    check(first_rel <= PARITY_TOL, f"first-solve parity {first_rel:.3e}")


# ---------------------------------------------------------------- phase 3
def phase3_rollout(seed, n_envs=512, n_intervals=2):
    import jax
    import jax.numpy as jnp

    from iterative_learning_nmpc_tpu.learning.ondevice import (
        make_batched_mpc_rollout,
    )
    from iterative_learning_nmpc_tpu.models import dynamics as dyn
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    spec = go2_spec()
    q0 = np.asarray(spec.q_home, np.float32).copy()
    p0 = np.asarray(jax.jit(lambda qq: dyn.foot_positions(spec, qq))(q0))
    q0[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
    rng = np.random.default_rng(seed)
    x0 = np.tile(np.concatenate([q0, np.zeros(18, np.float32)])[None],
                 (n_envs, 1))
    x0[:, 6:18] += rng.normal(0.0, 0.02, (n_envs, 12)).astype(np.float32)
    vdes = np.tile(np.array([[0.3, 0.0, 0.0]], np.float32), (n_envs, 1))
    rollout = make_batched_mpc_rollout(spec, n_intervals=n_intervals)
    t0 = time.perf_counter()
    out = jax.block_until_ready(rollout(jnp.asarray(x0), jnp.asarray(vdes)))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(rollout(jnp.asarray(x0), jnp.asarray(vdes)))
    run_s = time.perf_counter() - t0
    steps = out.q.shape[1]
    z = np.asarray(out.q[:, :, 2])
    finite = all(np.isfinite(np.asarray(a)).all()
                 for a in (out.q, out.state44, out.action))
    report(3, envs=n_envs, steps=steps, run_s=run_s,
           first_s_incl_compile=first_s,
           env_sim_s_per_s=n_envs * steps * 1e-3 / run_s,
           z_min=float(z.min()), z_max=float(z.max()), finite=finite)
    check(finite, "non-finite rollout outputs")
    check(z.min() >= 0.18 and z.max() <= 0.45,
          f"base height out of [0.18, 0.45]: {z.min():.3f}..{z.max():.3f}")


# ---------------------------------------------------------------- phase 4
def phase4_training(seed, n_steps=20):
    import jax
    import optax

    from iterative_learning_nmpc_tpu.learning.network import (
        init_network,
        make_numpy_apply,
        make_policy_apply,
        sample_policy_inputs,
    )
    from iterative_learning_nmpc_tpu.learning.train import (
        BehavioralCloning,
        TrainConfig,
    )
    from iterative_learning_nmpc_tpu.utils.device import rel_err

    cfg = TrainConfig()
    rng = np.random.default_rng(seed)
    net, variables = init_network(
        jax.random.PRNGKey(seed), cfg.input_size, cfg.output_size,
        cfg.num_hidden_layer, cfg.hidden_dim, cfg.batch_norm,
        cfg.dropout_rate)
    tx = optax.adam(cfg.learning_rate)
    train_epoch, eval_loss = BehavioralCloning(cfg)._make_step(net, tx)
    teacher = rng.normal(0.0, 0.3, (cfg.input_size, cfg.output_size))
    shape = (2, n_steps, cfg.batch_size, cfg.input_size)
    xs = rng.normal(size=shape).astype(np.float32)
    ys = np.tanh(xs @ teacher).astype(np.float32)
    x_val, y_val = xs[0, 0], ys[0, 0]
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    loss0 = float(eval_loss(params, stats, x_val, y_val))
    key = jax.random.PRNGKey(seed)
    losses, times = [], []
    for e in range(2):
        t0 = time.perf_counter()
        params, stats, opt_state, loss = jax.block_until_ready(train_epoch(
            params, stats, opt_state, xs[e], ys[e], jax.random.fold_in(key, e)))
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    loss1 = float(eval_loss(params, stats, x_val, y_val))

    x = sample_policy_inputs(POLICY, 256, seed=seed)
    a_dev = np.asarray(jax.jit(jax.vmap(make_policy_apply(POLICY)))(x))
    a_np = make_numpy_apply(POLICY)(x)
    pol_rel = rel_err(a_dev, a_np)
    report(4, steps=2 * n_steps, batch=cfg.batch_size,
           width=f"{cfg.input_size}->{cfg.hidden_dim}x{cfg.num_hidden_layer}"
                 f"->{cfg.output_size}",
           epoch_loss=f"{losses[0]:.4f},{losses[1]:.4f}",
           eval_loss_before=loss0, eval_loss_after=loss1,
           rows_per_s=n_steps * cfg.batch_size / times[1],
           policy_vs_numpy=pol_rel)
    check(all(np.isfinite(losses)) and np.isfinite(loss1), "non-finite loss")
    check(losses[1] < losses[0] and loss1 < loss0, "loss did not decrease")
    check(pol_rel <= POLICY_TOL, f"policy forward vs numpy {pol_rel:.3e}")


# ---------------------------------------------------------------- phase 5
def synthetic_blocks(seed, batch, n_nodes):
    """Well-conditioned random GN blocks (SPD Q, R, P_N) from a seed."""
    rng = np.random.default_rng(seed)

    def spd(lead, n):
        a = rng.normal(size=lead + (n + 8, n)).astype(np.float32)
        return (np.einsum("...ri,...rj->...ij", a, a) / (n + 8)
                + np.eye(n, dtype=np.float32))

    B, N = batch, n_nodes
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (spd((B, N), 36), spd((B, N), 30), 0.1 * f(B, N, 36, 30),
            f(B, N, 36), f(B, N, 30), spd((B,), 36), f(B, 36),
            0.01 * f(B, N, 36), 0.01 * f(B, 36))


def kernel_vs_xla(seed, batch, n_nodes, h=0.04, lm=1e-6, interpret=False):
    """max rel error of (K, kff, dX1, dU1): Triton kernel vs XLA scans."""
    import jax
    import jax.numpy as jnp

    from iterative_learning_nmpc_tpu.ops.riccati_triton import (
        riccati_rollout_batched,
    )
    from iterative_learning_nmpc_tpu.solver.sqp import (
        _forward_delta_structured,
        _riccati_solve_structured,
    )
    from iterative_learning_nmpc_tpu.utils.device import rel_err

    blocks = synthetic_blocks(seed, batch, n_nodes)

    def xla(Q, R, M, qx, ru, P_N, p_N, d, dx0):
        K, kff = _riccati_solve_structured(h, Q, R, M, qx, ru, P_N, p_N, d,
                                           jnp.float32(lm))
        dX, dU = _forward_delta_structured(h, K, kff, d, dx0,
                                           jnp.float32(1.0))
        return dX, dU, K, kff

    got = jax.jit(lambda *a: riccati_rollout_batched(
        h, lm, *a, interpret=interpret, return_gains=True))(*blocks)
    ref = jax.jit(jax.vmap(xla))(*blocks)
    return {name: rel_err(a, b)
            for name, a, b in zip(("dX1", "dU1", "K", "kff"), got, ref)}


def phase5_kernel(seed, p1, runs=5):
    import copy

    import jax

    from bench import _rti_chain
    from iterative_learning_nmpc_tpu.solver.sqp import TrajOptSolver

    errs = {}
    for n in (25, 100):
        for k, v in kernel_vs_xla(seed, 512, n).items():
            errs[f"{k}_N{n}"] = v

    # the same device-chained RTI step with the XLA sweep in place of the
    # kernel, timed in turns with phase 1's compiled chain
    solver, compiled_k, args, reps = p1
    opt = copy.deepcopy(solver.opt)
    opt.riccati_mode = "sequential"
    solver_x = TrajOptSolver(solver.spec, opt, solver.cost)
    compiled_x = jax.jit(jax.vmap(_rti_chain(solver_x, reps))).lower(
        *args).compile()
    jax.block_until_ready(compiled_x(*args))
    tk, tx = [], []
    for _ in range(runs):
        for fn, ts in ((compiled_k, tk), (compiled_x, tx)):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append((time.perf_counter() - t0) / reps * 1e3)
    mk, mx = float(np.median(tk)), float(np.median(tx))
    report(5, batch=args[0].shape[0], N=solver.N,
           rti_step_ms_kernel=mk, rti_step_ms_xla=mx,
           spread_ms_kernel=float(max(tk) - min(tk)),
           spread_ms_xla=float(max(tx) - min(tx)),
           speedup=mx / mk, **errs)
    worst = max(errs.values())
    check(worst <= KERNEL_TOL, f"kernel vs XLA sweep {worst:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU dp mesh path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from iterative_learning_nmpc_tpu.utils.device import require_gpu

    device = require_gpu()                                   # phase 0
    from iterative_learning_nmpc_tpu.utils.compile_cache import (
        setup_compile_cache,
    )

    setup_compile_cache()
    t0 = time.perf_counter()
    if args.four:
        from __graft_entry__ import dryrun_multichip

        check(device["count"] == 4, f"--four needs 4 GPUs, found "
                                    f"{device['count']}")
        dryrun_multichip(4)
        report("4gpu", wall_s=time.perf_counter() - t0)
    else:
        # one worker thread runs the CPU oracles while the GPU compiles
        with ThreadPoolExecutor(max_workers=1) as pool:
            replan_ref = pool.submit(replan_oracle)
            p1 = phase1_batched_rti(args.seed, pool)
            phase2_replans(replan_ref)
        phase3_rollout(args.seed)
        phase4_training(args.seed)
        phase5_kernel(args.seed, p1)
        report("all", wall_s=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
