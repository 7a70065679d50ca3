"""Envelope curriculum: train ONE policy that walks MuJoCo pure at
vx in {0.3, 0.15, 0.0, -0.15} (the reference goal set of
`DAgger/example/iter_locosafedagger.py:55-57` plus the 0.3 m/s BC
pretrain ceiling of `data_collection_pretrain_omini_vc_policy_...py:168`).

Staged chain, all data from the jax_sim plant (zero MuJoCo rows):
  0. BC seed: expert datagen over the FULL velocity envelope
     (vx in [-0.2, 0.35], vy noise), domain-randomized, warm-started from
     the shipped round-3 artifact.
  A. randomized SafeDAgger at the forward goals (0.15, 0.3) with
     base-state noise (height/tilt/velocity recovery data),
  B. same at the zero/backward goals (0.0, -0.15),
  C. 0.3-focused iterations with a TIGHTENED monitor height band
     (0.24-0.40 m) so the expert relabels on height DRIFT — the measured
     0.3 m/s sim-to-oracle failure mode (docs/TRANSFER.md),
  D. consolidation pass over all four goals.

After each stage: batched jax_sim pure eval at the 4 goals (cheap, one
device call). MuJoCo oracle evals run in a separate CPU process via
`exp_dagger_transfer.py --policy <out>/policy_envelope_final.pkl --cpu`.

    python scripts/exp_envelope.py --out /root/expr/envelope
"""
import argparse
import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets",
    "policy_go2_trot_ondevice_dagger.pkl")
EVAL_VX = (0.3, 0.15, 0.0, -0.15)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/root/expr/envelope")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed_batch", type=int, default=128)
    ap.add_argument("--seed_seconds", type=float, default=3.0)
    ap.add_argument("--seed_epochs", type=int, default=250)
    ap.add_argument("--sim_time", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--eval_secs", type=float, default=5.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--init_policy", default=ARTIFACT)
    ap.add_argument("--skip_seed", action="store_true",
                    help="reuse --out/bc data + policy from a previous run")
    ap.add_argument("--stages", default="A,B,C,D")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
        setup_compile_cache,
    )

    setup_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from iterative_learning_nmpc_tpu.learning.dagger import (
        OnDeviceSafeDagger,
        SafeDaggerConfig,
    )
    from iterative_learning_nmpc_tpu.learning.database import Database
    from iterative_learning_nmpc_tpu.learning.network import load_policy
    from iterative_learning_nmpc_tpu.learning.ondevice import (
        make_batched_mpc_rollout,
    )
    from iterative_learning_nmpc_tpu.learning.randomize import (
        randomize_payload,
        randomize_terrain,
        sample_force_windows,
    )
    from iterative_learning_nmpc_tpu.learning.train import (
        BehavioralCloning,
        TrainConfig,
    )
    from iterative_learning_nmpc_tpu.models import dynamics as dyn
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.sim import jax_sim

    spec = go2_spec()
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)

    q0 = np.asarray(spec.q_home, np.float32).copy()
    p0 = np.asarray(jax.jit(lambda q: dyn.foot_positions(spec, q))(q0))
    q0[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
    x0 = np.concatenate([q0, np.zeros(18, np.float32)])

    # ---------------- stage 0: BC seed over the full envelope ----------------
    bc_dir = os.path.join(args.out, "bc")
    data_path = os.path.join(bc_dir, "data.hdf5")
    policy_path = os.path.join(bc_dir, "policies", "policy_seed_final.pkl")
    if not args.skip_seed:
        os.makedirs(bc_dir, exist_ok=True)
        B = args.seed_batch
        x0b = np.tile(x0[None], (B, 1))
        x0b[:, 6:18] += rng.normal(0, 0.03, (B, 12)).astype(np.float32)
        x0b[:, 2] += np.clip(rng.normal(0, 0.02, B), -0.05, 0.05
                             ).astype(np.float32)
        x0b[:, 4:6] += rng.normal(0, 0.05, (B, 2)).astype(np.float32)
        x0b[:, 18:21] += rng.normal(0, 0.1, (B, 3)).astype(np.float32)
        vdes = np.zeros((B, 3), np.float32)
        vdes[:, 0] = rng.uniform(-0.2, 0.35, B)
        vdes[:, 1] = rng.uniform(-0.05, 0.05, B)
        # pin half of the envs to the exact eval goals (stride 2*len ->
        # each goal gets B/8 envs, 4*B/8 = B/2 pinned total)
        for i, g in enumerate(EVAL_VX):
            vdes[i::2 * len(EVAL_VX), 0] = g
            vdes[i::2 * len(EVAL_VX), 1] = 0.0

        n_intervals = int(round(args.seed_seconds / 0.04))
        rollout = make_batched_mpc_rollout(spec, n_intervals=n_intervals)
        ps = randomize_payload(spec, jax.random.PRNGKey(11), B)
        tr = randomize_terrain(jax.random.PRNGKey(12), B)
        fw = np.array(sample_force_windows(
            jax.random.PRNGKey(13), B, n_intervals * 40))
        fw[: B // 2] = 0.0
        t0 = time.time()
        out = rollout(jnp.asarray(x0b), jnp.asarray(vdes), ps, tr,
                      force_windows=jnp.asarray(fw, jnp.float32))
        jax.block_until_ready(out.q)
        T = out.q.shape[1]
        print(f"[seed] {B} envs x {args.seed_seconds}s in "
              f"{time.time()-t0:.1f}s", flush=True)
        states = np.asarray(out.state44).reshape(-1, 44)
        actions = np.asarray(out.action).reshape(-1, 12)
        valid = np.asarray(out.valid).reshape(-1) > 0.5
        goals = np.repeat(vdes, T, axis=0)
        db = Database(limit=max(int(valid.sum()), 1), goal_type="vc")
        db.append(states[valid], actions[valid], vc_goals=goals[valid],
                  traj_id=np.repeat(np.arange(B), T)[valid],
                  times=np.tile(np.arange(T) * 1e-3, B)[valid])
        db.save_as_hdf5(data_path)
        print(f"[seed] dataset {len(db)} rows ({valid.mean():.1%} valid)",
              flush=True)

        tc = TrainConfig(n_epochs=args.seed_epochs, learning_rate=1e-3,
                         save_dir=os.path.join(bc_dir, "policies"),
                         run_name="seed",
                         ckpt_every=max(args.seed_epochs // 2, 1))
        bc = BehavioralCloning(tc)
        t0 = time.time()
        policy_path = bc.run(db, warm_start_path=args.init_policy)
        m = bc.metrics[-1]
        print(f"[seed] {args.seed_epochs} epochs in {time.time()-t0:.1f}s "
              f"train={m['train_loss']:.4f} val={m['val_loss']:.4f}",
              flush=True)

    # ---------------- jax_sim pure eval helper ----------------
    T_eval = int(args.eval_secs * 1000)

    def sim_eval(path, tag):
        net, variables, norm = load_policy(path)
        mu_s, sd_s, mu_g, sd_g = [np.asarray(x, np.float32) for x in norm]
        sd_s = np.where(sd_s > 1e-8, sd_s, 1.0)

        def apply_fn(x):
            s, g = x[:44], x[44:]
            s = s.at[1:].set((s[1:] - mu_s[1:]) / sd_s[1:])
            g = (g - mu_g) / sd_g
            return net.apply(variables, jnp.concatenate([s, g])[None],
                             train=False)[0]

        ro = jax_sim.make_batched_policy_rollout(spec, apply_fn, T_eval)
        G = len(EVAL_VX)
        vg = np.zeros((G, 3), np.float32)
        vg[:, 0] = EVAL_VX
        Q, V, fell = ro(jnp.tile(q0[None], (G, 1)), jnp.zeros((G, 18)),
                        jnp.asarray(vg))
        Q = np.asarray(Q)
        res = {}
        for i, g in enumerate(EVAL_VX):
            bad = (Q[i, :, 2] < 0.15) | (np.abs(Q[i, :, 4:6]).max(axis=1) > 0.6)
            tf = int(np.argmax(bad)) if bad.any() else T_eval
            res[g] = (tf / 1000.0, float(Q[i, min(tf, T_eval - 1), 0]))
            print(f"[{tag}] jax_sim pure vx={g:+.2f}: "
                  f"t_fall={tf/1000:.2f}s x={res[g][1]:+.2f}", flush=True)
        return res

    sim_eval(policy_path, "seed")

    # ---------------- DAgger stages ----------------
    STAGES = {
        "A": dict(goals=((0.15, 0, 0), (0.3, 0, 0)), tight=False, bn=1.0),
        "B": dict(goals=((0.0, 0, 0), (-0.15, 0, 0)), tight=False, bn=1.0),
        "C": dict(goals=((0.3, 0, 0), (0.25, 0, 0)), tight=True, bn=1.0),
        "D": dict(goals=((0.3, 0, 0), (0.15, 0, 0), (0.0, 0, 0),
                         (-0.15, 0, 0)), tight=False, bn=0.5),
    }
    dataset_path = data_path
    history = {}
    for s in args.stages.split(","):
        st = STAGES[s]
        cfg = SafeDaggerConfig(
            record_dir=os.path.join(args.out, f"stage{s}"),
            sim_time=args.sim_time, n_epochs=args.epochs,
            learning_rate=1e-3, batch_size=1024, mpc_min_steps=1000,
            goals=st["goals"],
            n_iterations_per_goal=(args.iters if s != "D" else 1),
            seed=ord(s[0]),
            x0_z_noise=0.02 * st["bn"], x0_rpy_noise=0.05 * st["bn"],
            x0_vel_noise=0.10 * st["bn"],
            unsafe_height_bounds=(0.24, 0.40) if st["tight"] else None,
        )
        pipe = OnDeviceSafeDagger(spec, cfg, initial_policy=policy_path,
                                  initial_dataset=dataset_path,
                                  batch=args.batch, randomize=True)
        t0 = time.time()
        policy_path = pipe.run()
        dataset_path = pipe.dataset_path
        print(f"[stage {s}] {len(pipe.expert_ratio_history)} iters in "
              f"{time.time()-t0:.0f}s, expert ratios "
              f"{[round(r, 3) for r in pipe.expert_ratio_history]}",
              flush=True)
        history[s] = sim_eval(policy_path, f"stage {s}")

    final = os.path.join(args.out, "policy_envelope_final.pkl")
    import shutil

    shutil.copy(policy_path, final)
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump({k: {str(g): v for g, v in h.items()}
                   for k, h in history.items()}, f, indent=1)
    print(f"final policy: {final}\ndataset: {dataset_path}", flush=True)


if __name__ == "__main__":
    main()
