"""Cold-boot warm starts with the SHIPPED artifact: measured decomposition.

BASELINE.json north star: "learned-policy warm-starts feed back into the
solver to cut iterations". Round 5 closed the round-4 phase-mismatch
diagnosis by decomposing the warm start's value (regenerate with
scripts/bench_warmstart.py):

| init (vs state), CPU fp32 | home        | midgait     | recovery     |
|---------------------------|-------------|-------------|--------------|
| naive (x0-replicated,     | 15*, 7933   | 15*, 5806   | 15*, 14174   |
|   zero inputs, acados-ish)|             |             |              |
| engineered cold_start @0  |  6, 1741    |  6,  904    |  7,  5878    |
| policy rollout @0 (r4)    |  5, 1757    | 15,  904    | 15,  5878    |
| policy + contact-match    |  9, 1717    | 14,  841    | 15,  5878    |
| merit_phase_boot (PROD)   |  6, 1717    |  5,  688    |  5,  5682    |

(* = hit the 15-iteration cap; cost = GN cost after the run. The
accelerator run agreed on every merit_boot row: 6/5/5 iterations, same
costs.)

Measured decomposition (details in solver/warmstart.py docstrings):
1. The policy rollout (X, U) GUESS never beats the engineered stationary
   cold start — at every iteration budget the rollout's contact-pinning
   residuals cost more GN work (midgait cost after 1/3/6 iters:
   1.2e6/5.1e4/880 rollout vs 1.3e4/841/841 stationary).
2. The GAIT-PHASE OFFSET of the schedule is where a cold boot has real
   freedom: converged cost spans 688..904 (midgait) and 5682..9909
   (recovery) across the 12 trot offsets.
3. The policy's emergent contact pattern picks that offset UNRELIABLY
   (its own duty cycle/period != planner schedule: picks 1 vs true 10 on
   midgait); a vmapped 3-iteration merit probe over all offsets
   (`merit_phase_boot`) is exact on every tested state — it is the
   production LocomotionMPC cold-boot/divergence-recovery path
   (phase_aligned_boot=True, recover_on_divergence).

Pinned below: the policy-vs-naive strict win (basin robustness), and the
merit boot's exactness + iteration cut (test_merit_phase_boot_*).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from iterative_learning_nmpc_tpu.gait.planner import ContactPlanner
from iterative_learning_nmpc_tpu.learning.network import load_policy
from iterative_learning_nmpc_tpu.models import dynamics as dyn
from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config
from iterative_learning_nmpc_tpu.solver.sqp import TrajOptSolver, make_params
from iterative_learning_nmpc_tpu.solver.warmstart import policy_warmstart

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets",
    "policy_go2_trot_ondevice_dagger.pkl")


def _artifact_apply():
    net, variables, norm = load_policy(ARTIFACT)
    mu_s, sd_s, mu_g, sd_g = [np.asarray(x, np.float32) for x in norm]
    sd_s = np.where(sd_s > 1e-8, sd_s, 1.0)

    def apply_fn(x):
        s, g = x[:44], x[44:]
        s = s.at[1:].set((s[1:] - mu_s[1:]) / sd_s[1:])
        g = (g - mu_g) / sd_g
        return net.apply(variables, jnp.concatenate([s, g])[None],
                         train=False)[0]

    return apply_fn


def _start_states(spec):
    q0 = np.asarray(spec.q_home, np.float32).copy()
    p0 = np.asarray(jax.jit(lambda q: dyn.foot_positions(spec, q))(q0))
    q0[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
    states = {}
    states["home"] = np.concatenate([q0, np.zeros(18, np.float32)])
    qs = q0.copy()
    qs[2] -= 0.02
    qs[6:18] += np.random.default_rng(1).normal(0, 0.05, 12).astype(np.float32)
    vs = np.zeros(18, np.float32)
    vs[0] = 0.3
    states["midgait"] = np.concatenate([qs, vs])
    # post-divergence recovery: height droop, tilt, off-axis velocity
    qr = q0.copy()
    qr[2] -= 0.06
    qr[4] = 0.15
    qr[5] = -0.1
    vr = np.zeros(18, np.float32)
    vr[[0, 1, 2]] = (0.1, -0.2, -0.3)
    states["recovery"] = np.concatenate([qr, vr])
    return states


@pytest.mark.slow
def test_artifact_warmstart_cuts_solver_work(go2):
    gait, opt, cost = get_quadruped_config("trot", "go2")
    solver = TrajOptSolver(go2, opt, cost)
    N = solver.N
    planner = ContactPlanner(go2.feet_frame_names, solver.dt_nodes, gait)
    apply_fn = _artifact_apply()
    v_des = np.array([0.3, 0.0, 0.0], np.float32)

    solve = jax.jit(lambda X, U, p, n: solver.solve(X, U, p, n),
                    static_argnums=3)
    ws = jax.jit(lambda p: policy_warmstart(solver, apply_fn, p, v_des))
    cold = jax.jit(solver.cold_start)

    results = {}
    for name, x0 in _start_states(go2).items():
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
        assert np.isfinite(np.asarray(Xw)).all()
        assert np.isfinite(np.asarray(Uw)).all()
        sw = solve(Xw, Uw, p, 15)
        results[name] = dict(
            naive=(int(sn.stats.sqp_iters), float(sn.stats.cost)),
            cold=(int(sc.stats.sqp_iters), float(sc.stats.cost)),
            warm=(int(sw.stats.sqp_iters), float(sw.stats.cost)),
        )

    for name, r in results.items():
        # strict win vs the reference-style naive init on EVERY state:
        # fewer-or-equal iterations AND a strictly (much) better solution
        assert r["warm"][0] <= r["naive"][0], (name, r)
        assert r["warm"][1] < 0.8 * r["naive"][1], (name, r)
        # and the warm solve must land on the engineered-cold solution
        assert r["warm"][1] < 1.05 * r["cold"][1] + 20.0, (name, r)

    # strict ITERATION reduction where the gait phase is alignable: the
    # from-rest cold-boot state (the production first-solve path)
    assert results["home"]["warm"][0] < results["home"]["cold"][0], results
    assert results["home"]["naive"][0] == 15, results  # naive never converges

@pytest.mark.slow
def test_merit_phase_boot_finds_true_best_offset(go2):
    """The production cold-boot path (LocomotionMPC phase_aligned_boot):
    a vmapped 3-iteration probe over all planner offsets must rank the
    SAME offset a full 15-iteration solve ranks best, and that offset's
    solution must be at least as good as the fixed offset-0 boot.
    Measured spread this guards (CPU fp32): midgait 688..904, recovery
    5682..9909 converged cost across the 12 trot offsets."""
    import dataclasses as dc

    from iterative_learning_nmpc_tpu.solver.warmstart import (
        contact_windows,
        merit_phase_boot,
    )

    gait, opt, cost = get_quadruped_config("trot", "go2")
    solver = TrajOptSolver(go2, opt, cost)
    N = solver.N
    planner = ContactPlanner(go2.feet_frame_names, solver.dt_nodes, gait)
    W = jnp.asarray(contact_windows(planner, N))
    v_des = np.array([0.3, 0.0, 0.0], np.float32)

    def full_cost(p, w):
        p2 = dc.replace(p, cnt=w, peak=1.0 - w)
        X, U = solver.cold_start(p2)
        s = solver.solve(X, U, p2, 15)
        return s.stats.cost, s.stats.sqp_iters

    vm_full = jax.jit(jax.vmap(lambda p, w: full_cost(p, w),
                               in_axes=(None, 0)))
    boot = jax.jit(lambda p: merit_phase_boot(solver, p, W))

    for name, x0 in _start_states(go2).items():
        cnt = planner.get_contacts(0, N + 1)
        base_ref = np.zeros(12, np.float32)
        base_ref[:3] = x0[:3]
        base_ref[2] = gait.nom_height
        base_ref[6] = v_des[0]
        p = make_params(solver, x0, cnt, base_ref=base_ref,
                        step_height=gait.step_height)
        truth_cost, truth_iters = [np.asarray(a) for a in vm_full(p, W)]
        p2, off, probe = boot(p)
        off = int(off)
        assert off == int(truth_cost.argmin()), (
            name, off, truth_cost.round(0).tolist())
        # the boot solution is at least as good as the offset-0 boot and
        # costs no more iterations
        assert truth_cost[off] <= truth_cost[0] + 1e-3, (name, truth_cost)
        assert truth_iters[off] <= truth_iters[0], (name, truth_iters)
        assert np.allclose(np.asarray(p2.cnt), np.asarray(W[off]))
