"""In-plant iterative SafeDAgger at reference scale (VERDICT r4 item 1).

The reference's flagship modality: iterative LocoSafeDAgger IN the
deployment plant (MuJoCo) — combined-controller rollouts, expert-row
relabeling, aggregation into one running dataset, warm-started retrain,
iterated over velocity goals, producing ONE policy
(`/root/reference/DAgger/example/iter_locosafedagger.py:54-102`,
`DAgger/utils/data_collection_locosafedagger.py:133-224`,
`DAgger/utils/train_locosafedagger.py:152-191`).

Protocol here (reference values, upgrades noted):
- goal blocks [0.15, 0.0, -0.15] x n_iter each (reference), +0.3 stretch
  block; 10 s combined rollouts, monitor v2, delay 100, latch 2500;
- K parallel rollouts per data step (reference runs 1; K>1 with small
  joint-noise start states diversifies the same way its perturbed-restart
  expert rollouts do) — all expert rows aggregate into ONE dataset;
- retrain: warm start from the current policy, 15 epochs Adam 1e-3
  batch 256 (`DAgger/cfgs/iter_locosafedagger.yaml:69-72`);
- after every retrain: pure-policy 4-goal MuJoCo screen (the reference's
  checkpoint-survival protocol, `DAgger/test/test_policy_rollout.py:41-55`).

Everything is subprocess-per-stage so collects parallelize on CPU cores
and a retrain can target the GPU without the orchestrator importing JAX.

    python scripts/exp_inplant_dagger.py drive --out /root/repo/.expr/dagger5

MEASURED OUTCOME (round 5, the faithful 16-step run): at single-env
collection rates (~0.12 env-sim-s per wall-second) the protocol is
data-starved — every checkpoint was fragile under perturbed starts
(screen --n_starts 3: 0/4 robust throughout), mirroring the near-
threshold tipping the reference's own checkpoint logs show. The run that
produced the shipped robust artifact uses the SAME protocol through the
batched-expert plant collector at ~60x the rate
(learning/plant_batch.py, scripts/exp_plant_scale.py,
BENCH_INPLANT.json). This driver remains the reference-faithful
single-env form, and its `collect`/`train`/`screen` subcommands are the
shared building blocks of the scale campaign.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOALS_SCREEN = (0.3, 0.15, 0.0, -0.15)


def _cpu_jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
        setup_compile_cache,
    )

    setup_compile_cache()


# ---------------------------------------------------------------------------
def cmd_collect(args):
    """One combined-controller rollout; writes recorder rows npz + a result
    json (expert ratio, survival)."""
    _cpu_jax()
    import numpy as np

    from iterative_learning_nmpc_tpu.learning.rollouts import rollout_combined
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.sim.mujoco_sim import Simulator

    spec = go2_spec()
    sim = Simulator(spec)
    rng = np.random.default_rng(args.seed)
    start_state = None
    if args.joint_noise > 0:
        sim.reset()
        q0 = np.asarray(sim.data.qpos).copy()
        v0 = np.asarray(sim.data.qvel).copy()
        q0[7:] += rng.normal(0.0, args.joint_noise, 12)
        start_state = (q0, v0)
    forces = None
    if args.n_pushes > 0:
        # reference-magnitude randomized base pushes (50-70 N, 0.2-0.4 s)
        from iterative_learning_nmpc_tpu.learning.rollouts import (
            sample_force_perturbation,
        )

        seg = args.sim_time / args.n_pushes
        forces = [sample_force_perturbation(rng, i * seg + 1.0,
                                            (i + 1) * seg - 0.5)
                  for i in range(args.n_pushes)]

    t0 = time.time()
    r = rollout_combined(
        spec, args.policy, sim_time=args.sim_time,
        v_des=np.array([args.vx, 0.0, 0.0]),
        record_dir=os.path.dirname(args.out_npz), simulator=sim,
        monitor=args.monitor, delay_steps=args.delay_steps,
        mpc_min_steps=args.mpc_min_steps, start_state=start_state,
        force_schedule=forces,
    )
    rec = r.recorder
    data = {k: np.asarray(v) for k, v in rec.data.items()}
    np.savez(args.out_npz, **data)
    is_expert = data["is_expert"].astype(bool)
    res = dict(
        npz=args.out_npz, vx=args.vx, seed=args.seed,
        sim_time=float(r.sim.sim_time), fell=bool(r.sim.fell),
        steps=int(len(is_expert)), expert_steps=int(is_expert.sum()),
        expert_ratio=float(is_expert.mean()) if len(is_expert) else 0.0,
        wall=round(time.time() - t0, 1),
    )
    with open(args.out_json, "w") as f:
        json.dump(res, f)
    print(f"[collect] vx={args.vx:+.2f} seed={args.seed}: "
          f"t={res['sim_time']:.1f}s fell={res['fell']} "
          f"expert {res['expert_steps']}/{res['steps']} "
          f"({res['expert_ratio']:.3f}) wall={res['wall']}s", flush=True)


# ---------------------------------------------------------------------------
def cmd_train(args):
    """Aggregate expert rows into the running dataset, retrain warm-started.
    Prints 'FINAL <path>' on success."""
    if args.device == "cpu":
        _cpu_jax()
    else:
        import jax

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

    db = Database(limit=10_000_000, goal_type="vc")
    for prev in (args.prev.split(",") if args.prev else []):
        if prev and os.path.exists(prev):
            db.load_saved_database(prev)
    n_prev = len(db)
    traj_base = args.traj_base
    for i, npz_path in enumerate(args.rows):
        d = np.load(npz_path)
        keep = d["is_expert"].astype(bool)
        if not keep.any():
            continue
        db.append(
            d["state"][keep], d["action"][keep],
            vc_goals=d["vc_goals"][keep], cc_goals=d["cc_goals"][keep],
            traj_id=np.full(int(keep.sum()), traj_base + i),
            times=d["time"][keep],
        )
    print(f"[train] aggregate: {n_prev} prev + {len(db) - n_prev} new "
          f"expert rows = {len(db)}", flush=True)
    db.save_as_hdf5(args.out_h5)

    tc = TrainConfig(
        learning_rate=args.lr, batch_size=args.batch_size,
        n_epochs=args.epochs, save_dir=args.save_dir,
        run_name=args.run_name, seed=args.seed,
        ckpt_every=max(args.epochs, 1),  # final only
    )
    bc = BehavioralCloning(tc)
    weights = None
    if args.balance_goals:
        # per-goal-bin balanced sampling: equal expected draw volume per
        # commanded-vx bin — the measured interference mitigation for the
        # single multi-goal policy (docs/TRANSFER.md sloshing analysis)
        vx = db.goals_array()[:, 0]
        bins = np.round(vx / 0.05).astype(int)
        _, inv, cnt = np.unique(bins, return_inverse=True,
                                return_counts=True)
        weights = 1.0 / cnt[inv]
        print(f"[train] goal-balanced sampling over "
              f"{len(cnt)} vx bins (rows/bin min {cnt.min()} "
              f"max {cnt.max()})", flush=True)
    if args.inplant_weight != 1.0 and len(db) > args.base_rows:
        # upweight the IN-PLANT expert rows (append order beyond the
        # curriculum base) so the plant-relabeled data is not homeopathic
        # against a multi-million-row sim aggregate — same mechanism as
        # the reference's OOD x5 WeightedRandomSampler
        if weights is None:
            weights = np.ones(len(db))
        weights = weights.copy()
        weights[args.base_rows:] *= args.inplant_weight
        print(f"[train] in-plant rows [{args.base_rows}:{len(db)}] "
              f"x{args.inplant_weight}", flush=True)
    t0 = time.time()
    final = bc.run(db, warm_start_path=args.warm_start,
                   sample_weights=weights)
    m = bc.metrics[-1]
    print(f"[train] {args.epochs} epochs in {time.time()-t0:.0f}s "
          f"train={m['train_loss']:.4f} val={m['val_loss']:.4f}", flush=True)
    print(f"FINAL {final}", flush=True)


# ---------------------------------------------------------------------------
def cmd_screen(args):
    """Pure-policy 4-goal MuJoCo screen -> json. 'walks' = survives
    eval_secs AND makes >=40% commanded-direction progress (stand: |x|<0.5).

    --n_starts > 1 adds PERTURBED initial states (joint noise, seeds
    1..n-1) on top of the clean start; a goal passes when >= pass_frac of
    its starts walk. This is the selection-robustness screen (VERDICT r4
    weak #4: single clean-start screens certify lucky checkpoints — the
    r4 envelope bundle measures 1/3, 3/3, 0/3, 0/3 robust under 0.03 rad
    joint noise at {0.3, 0.15, 0.0, -0.15})."""
    _cpu_jax()
    import numpy as np

    from iterative_learning_nmpc_tpu.learning.policy_controller import (
        PolicyController,
    )
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.sim.mujoco_sim import Simulator

    spec = go2_spec()
    res = {}
    for g in GOALS_SCREEN:
        starts = []
        for k in range(args.n_starts):
            sim = Simulator(spec)
            if k > 0:
                rng = np.random.default_rng(k)
                sim.reset()
                q0 = np.asarray(sim.data.qpos).copy()
                v0 = np.asarray(sim.data.qvel).copy()
                q0[7:] += rng.normal(0, args.start_noise, 12)
                v0[0:3] += rng.normal(0, 0.05, 3)
                sim.reset(q_mj=q0, v_mj=v0)
            pol = PolicyController(sim, args.policy,
                                   v_des=np.array([g, 0.0, 0.0]))
            r = sim.run(sim_time=args.eval_secs, controller=pol)
            x = float(sim.data.qpos[0])
            ok = (not r.fell) and r.sim_time >= args.eval_secs - 1e-6
            if g != 0.0:
                ok = ok and (np.sign(x) == np.sign(g)
                             and abs(x) >= 0.4 * abs(g) * args.eval_secs)
            else:
                ok = ok and abs(x) < 0.5
            starts.append(dict(t=round(float(r.sim_time), 2),
                               x=round(x, 2), ok=bool(ok)))
        n_pass = sum(1 for s in starts if s["ok"])
        goal_ok = n_pass >= max(1, int(np.ceil(args.pass_frac
                                               * len(starts))))
        res[str(g)] = dict(starts=starts, n_pass=n_pass, ok=bool(goal_ok),
                           t=starts[0]["t"], x=starts[0]["x"])
        print(f"[screen] vx={g:+.2f}: {n_pass}/{len(starts)} "
              f"{'OK' if goal_ok else '--'} {starts}", flush=True)
    res["n_ok"] = sum(1 for g in GOALS_SCREEN if res[str(g)]["ok"])
    with open(args.out_json, "w") as f:
        json.dump(res, f)
    print(f"[screen] {args.policy}: {res['n_ok']}/4", flush=True)


# ---------------------------------------------------------------------------
def cmd_drive(args):
    """The outer loop. Resumable via <out>/state.json."""
    out = args.out
    os.makedirs(out, exist_ok=True)
    state_path = os.path.join(out, "state.json")
    log_path = os.path.join(out, "log.jsonl")
    goal_blocks = [float(g) for g in args.goals.split(",")]
    steps = [(g, i) for g in goal_blocks for i in range(args.n_iter)]

    if os.path.exists(state_path):
        with open(state_path) as f:
            st = json.load(f)
    else:
        st = dict(policy=args.seed_policy, dataset=args.seed_datasets,
                  done=0)
    py = sys.executable
    me = os.path.abspath(__file__)

    def log(rec):
        rec["t"] = time.strftime("%H:%M:%S")
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    for step_i in range(st["done"], len(steps)):
        vx, it = steps[step_i]
        tag = f"s{step_i:02d}_vx{vx:+.2f}_it{it}".replace("+", "p").replace(
            "-", "m").replace(".", "")
        sdir = os.path.join(out, tag)
        os.makedirs(sdir, exist_ok=True)
        t0 = time.time()

        # ---- K parallel combined rollouts ----
        procs, jsons, npzs = [], [], []
        for k in range(args.k_rollouts):
            npz = os.path.join(sdir, f"rows_{k}.npz")
            js = os.path.join(sdir, f"rows_{k}.json")
            npzs.append(npz)
            jsons.append(js)
            cmd = [py, me, "collect", "--policy", st["policy"],
                   "--vx", str(vx), "--out_npz", npz, "--out_json", js,
                   "--sim_time", str(args.sim_time),
                   "--seed", str(1000 * step_i + k),
                   "--joint_noise", "0.0" if k == 0 else str(args.joint_noise),
                   "--mpc_min_steps", str(args.mpc_min_steps),
                   "--delay_steps", str(args.delay_steps),
                   "--monitor", args.monitor,
                   "--n_pushes", "0" if k == 0 else str(args.n_pushes)]
            lf = open(os.path.join(sdir, f"collect_{k}.log"), "w")
            procs.append((subprocess.Popen(cmd, stdout=lf, stderr=lf), lf))
        for p, lf in procs:
            p.wait()
            lf.close()
        collects = []
        for js in jsons:
            if os.path.exists(js):
                with open(js) as f:
                    collects.append(json.load(f))
        if not collects:
            raise RuntimeError(f"step {tag}: every collect worker failed")
        ratio = (sum(c["expert_steps"] for c in collects)
                 / max(sum(c["steps"] for c in collects), 1))

        # ---- aggregate + retrain ----
        agg = os.path.join(sdir, "agg_dataset.hdf5")
        cmd = [py, me, "train", "--prev", st["dataset"],
               "--out_h5", agg, "--warm_start", st["policy"],
               "--save_dir", os.path.join(out, "policies"),
               "--run_name", tag, "--epochs", str(args.epochs),
               "--lr", str(args.lr), "--batch_size", str(args.batch_size),
               "--device", args.train_device, "--seed", str(step_i),
               "--traj_base", str(1000 * (step_i + 1))]
        if args.balance_goals:
            cmd.append("--balance_goals")
        cmd += ["--inplant_weight", str(args.inplant_weight),
                "--base_rows", str(args.base_rows)]
        cmd += ["--rows"] + [n for n in npzs if os.path.exists(n)]
        tl = os.path.join(sdir, "train.log")
        with open(tl, "w") as lf:
            subprocess.run(cmd, stdout=lf, stderr=lf, check=True)
        final = None
        with open(tl) as f:
            for line in f:
                if line.startswith("FINAL "):
                    final = line.split(" ", 1)[1].strip()
        assert final and os.path.exists(final), f"no FINAL in {tl}"

        # ---- screen ----
        sj = os.path.join(sdir, "screen.json")
        with open(os.path.join(sdir, "screen.log"), "w") as lf:
            subprocess.run([py, me, "screen", "--policy", final,
                            "--out_json", sj,
                            "--eval_secs", str(args.eval_secs),
                            "--n_starts", str(args.screen_starts)],
                           stdout=lf, stderr=lf, check=True)
        with open(sj) as f:
            screen = json.load(f)

        st.update(policy=final, dataset=agg, done=step_i + 1)
        with open(state_path, "w") as f:
            json.dump(st, f, indent=1)
        rec = dict(step=step_i, tag=tag, vx=vx, iter=it,
                   expert_ratio=round(ratio, 4),
                   collects=[dict(t=c["sim_time"], fell=c["fell"],
                                  r=round(c["expert_ratio"], 3))
                             for c in collects],
                   screen={g: screen[g]["ok"] for g in map(str, GOALS_SCREEN)},
                   n_ok=screen["n_ok"], policy=final,
                   wall=round(time.time() - t0, 1))
        log(rec)
        print(f"[drive] {tag}: ratio={ratio:.3f} screen={screen['n_ok']}/4 "
              f"wall={rec['wall']}s -> {final}", flush=True)
    print("[drive] all steps done", flush=True)


# ---------------------------------------------------------------------------
def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("collect")
    c.add_argument("--policy", required=True)
    c.add_argument("--vx", type=float, required=True)
    c.add_argument("--out_npz", required=True)
    c.add_argument("--out_json", required=True)
    c.add_argument("--sim_time", type=float, default=10.0)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--joint_noise", type=float, default=0.0)
    c.add_argument("--mpc_min_steps", type=int, default=2500)
    c.add_argument("--delay_steps", type=int, default=100)
    c.add_argument("--monitor", default="v2")
    c.add_argument("--n_pushes", type=int, default=0)
    c.set_defaults(fn=cmd_collect)

    t = sub.add_parser("train")
    t.add_argument("--prev", default="")
    t.add_argument("--rows", nargs="*", default=[])
    t.add_argument("--out_h5", required=True)
    t.add_argument("--warm_start", required=True)
    t.add_argument("--save_dir", required=True)
    t.add_argument("--run_name", required=True)
    t.add_argument("--epochs", type=int, default=15)
    t.add_argument("--lr", type=float, default=1.0e-3)
    t.add_argument("--batch_size", type=int, default=256)
    t.add_argument("--device", default="cpu", choices=("cpu", "gpu"))
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--traj_base", type=int, default=1000)
    t.add_argument("--balance_goals", action="store_true")
    t.add_argument("--inplant_weight", type=float, default=1.0)
    t.add_argument("--base_rows", type=int, default=0)
    t.set_defaults(fn=cmd_train)

    s = sub.add_parser("screen")
    s.add_argument("--policy", required=True)
    s.add_argument("--out_json", required=True)
    s.add_argument("--eval_secs", type=float, default=5.0)
    s.add_argument("--n_starts", type=int, default=1)
    s.add_argument("--start_noise", type=float, default=0.03)
    s.add_argument("--pass_frac", type=float, default=0.6)
    s.set_defaults(fn=cmd_screen)

    d = sub.add_parser("drive")
    d.add_argument("--out", default=os.path.join(REPO, ".expr", "dagger5"))
    d.add_argument("--goals", default="0.15,0.0,-0.15,0.3")
    d.add_argument("--n_iter", type=int, default=4)
    d.add_argument("--k_rollouts", type=int, default=3)
    d.add_argument("--sim_time", type=float, default=10.0)
    d.add_argument("--joint_noise", type=float, default=0.03)
    d.add_argument("--mpc_min_steps", type=int, default=2500)
    d.add_argument("--delay_steps", type=int, default=100)
    d.add_argument("--monitor", default="v2")
    d.add_argument("--epochs", type=int, default=15)
    d.add_argument("--lr", type=float, default=1.0e-3)
    d.add_argument("--batch_size", type=int, default=256)
    d.add_argument("--train_device", default="cpu", choices=("cpu", "gpu"))
    d.add_argument("--eval_secs", type=float, default=5.0)
    d.add_argument("--screen_starts", type=int, default=1)
    d.add_argument("--balance_goals", action="store_true")
    d.add_argument("--n_pushes", type=int, default=0)
    d.add_argument("--inplant_weight", type=float, default=1.0)
    d.add_argument("--base_rows", type=int, default=0)
    d.add_argument("--seed_policy", default=os.path.join(
        REPO, "assets", "policy_go2_trot_host_bc.pkl"))
    d.add_argument("--seed_datasets", default=",".join([
        os.path.join(REPO, ".expr", "host", "collect_p015", "database_0.hdf5"),
        os.path.join(REPO, ".expr", "host", "collect_p030", "database_0.hdf5"),
    ]))
    d.set_defaults(fn=cmd_drive)

    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
