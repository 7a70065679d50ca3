"""Stage breakdown of one batched RTI iteration (B=512, N=25 by default).

Times, each alone under jit with block_until_ready: the full RTI step, the
linearize + Gram stage (`TrajOptSolver._gn_blocks`), and the Riccati sweep +
alpha=1 rollout, both as the Triton kernel and as the XLA scans. Used by
chip_smoke.py (phase 1); also runnable on its own on a GPU host:

    python scripts/profile_rti.py [batch]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def timeit(fn, *args, runs=5, reps=10):
    """Median wall ms per call over `runs` runs of `reps` calls each; every
    run ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / reps * 1e3)
    return float(np.median(times))


def batch_inputs(solver, X, U, params, batch, seed=0):
    """(Xb, Ub, pb): `batch` copies of one instance with x0 perturbed by
    0.01 * N(0, 1) per state (row 0 left unperturbed)."""
    import dataclasses

    rng = np.random.default_rng(seed)
    noise = 0.01 * rng.standard_normal((batch, X.shape[-1])).astype(np.float32)
    noise[0] = 0.0
    pb = {f.name: np.broadcast_to(np.asarray(getattr(params, f.name))[None],
                                  (batch,) + np.shape(getattr(params, f.name)))
          for f in dataclasses.fields(params)}
    pb["x0"] = pb["x0"] + noise
    pb = type(params)(**{k: np.ascontiguousarray(v) for k, v in pb.items()})
    Xb = np.broadcast_to(np.asarray(X)[None], (batch,) + X.shape).copy()
    Xb[:, 0] = pb.x0
    Ub = np.ascontiguousarray(
        np.broadcast_to(np.asarray(U)[None], (batch,) + U.shape))
    return Xb, Ub, pb


def stage_fns(solver):
    """Jitted batched stage functions: linearize+Gram, the Riccati sweep +
    rollout through the solver's dispatcher (Triton kernel when batched on
    a GPU), and the same through the XLA structured scans."""
    import jax
    import jax.numpy as jnp

    from iterative_learning_nmpc_tpu.solver.sqp import (
        _forward_delta_structured,
        _riccati_solve_structured,
    )

    h, lm = solver.dt_nodes, solver.opt.lm_reg

    def xla_sweep(Q, R, M, qx, ru, P_N, p_N, d, dx0):
        K, kff = _riccati_solve_structured(h, Q, R, M, qx, ru, P_N, p_N, d,
                                           jnp.asarray(lm, Q.dtype))
        return _forward_delta_structured(h, K, kff, d, dx0,
                                         jnp.asarray(1.0, Q.dtype))

    return {
        "linearize": jax.jit(jax.vmap(solver._gn_blocks)),
        "riccati": jax.jit(jax.vmap(solver._get_riccati_rollout())),
        "riccati_xla": jax.jit(jax.vmap(xla_sweep)),
    }


def stage_times(solver, Xb, Ub, pb, rti=None):
    """Wall ms of each stage at the batch given (dict). `rti`: an already
    jitted batched one-step solve to reuse."""
    import jax

    fns = stage_fns(solver)
    blocks = fns["linearize"](Xb, Ub, pb)
    if rti is None:
        rti = jax.jit(jax.vmap(lambda x, u, p: solver.solve(x, u, p, 1)))
    return {
        "rti_step_ms": timeit(rti, Xb, Ub, pb),
        "linearize_gram_ms": timeit(fns["linearize"], Xb, Ub, pb),
        "riccati_rollout_ms": timeit(fns["riccati"], *blocks),
        "riccati_rollout_xla_ms": timeit(fns["riccati_xla"], *blocks),
    }


def main():
    import jax

    from __graft_entry__ import _flagship

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    solver, X, U, params = _flagship()
    sol = jax.jit(lambda X, U, p: solver.solve(X, U, p, 15))(X, U, params)
    Xb, Ub, pb = batch_inputs(solver, sol.X, sol.U, params, batch)
    print(f"batch={batch} backend={jax.default_backend()} "
          f"device={jax.devices()[0].device_kind} "
          f"riccati_mode={solver._riccati_mode}")
    for k, v in stage_times(solver, Xb, Ub, pb).items():
        print(f"  {k:24s} {v:9.3f}")


if __name__ == "__main__":
    main()
