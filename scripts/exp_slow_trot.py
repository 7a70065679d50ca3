"""slow_trot closed-loop tuning experiments (VERDICT r2 item 3).

Runs a grid of cost/gait variants of the go2 slow_trot config through a 5 s
MuJoCo closed-loop sim at 0.15 m/s and reports survival + tracking, to find
a table that removes the KNOWN LIMITATION note in mpc/config.py.

    python scripts/exp_slow_trot.py [--variants v0 v2 ...] [--secs 5]
"""
import argparse
import copy
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
from iterative_learning_nmpc_tpu.utils.compile_cache import (  # noqa: E402
    setup_compile_cache,
)

setup_compile_cache()

import numpy as np

from iterative_learning_nmpc_tpu.mpc import config as C
from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu.sim.mujoco_sim import Simulator


def base_cost():
    return C.COSTS[("go2", "slow_trot")]()


def v0():
    """current table (reproduce the failure)"""
    return base_cost(), {}


def v1():
    """+ xy position & vx/vy velocity tracking (trot-style rows)"""
    c = base_cost()
    c.W_base = c.W_base.copy()
    c.W_base[0:2] = [5e2, 1e3]
    c.W_base[6:8] = [5e2, 1e1]
    return c, {}


def v2():
    """v1 + stronger roll/pitch + ang-vel damping"""
    c, g = v1()
    c.W_base[4:6] = [3e4, 3e4]
    c.W_base[9:12] = [1e1, 2e2, 4e2]
    return c, g


def v3():
    """trot cost table on the slow_trot gait timing"""
    c = C.COSTS[("go2", "trot")]()
    c.gait_name = "slow_trot"
    return c, {}


def v4():
    """v3 + slow_trot's stronger swing clearance"""
    c, g = v3()
    c.W_swing = np.array([5e5] * 4)
    return c, g


def v5():
    """v1 + taller steps (clearance for the slow swing)"""
    c, g = v1()
    return c, dict(step_height=0.085)


def v6():
    """v3 + taller steps"""
    c, g = v3()
    return c, dict(step_height=0.085)


def v7():
    """v3 with halved xy-position lead weight (tame the overshoot)"""
    c, g = v3()
    c.W_base = c.W_base.copy()
    c.W_base[0:2] = [3e2, 1e3]
    return c, g


def v8():
    """v7 + stronger vx tracking"""
    c, g = v7()
    c.W_base[6] = 2e3
    return c, g


def v9():
    """v4 + stronger vx tracking (keep slow_trot swing clearance)"""
    c, g = v4()
    c.W_base = c.W_base.copy()
    c.W_base[0] = 3e2
    c.W_base[6] = 2e3
    return c, g


VARIANTS = {k: fn for k, fn in list(globals().items())
            if k.startswith("v") and callable(fn)}


class _XRecorder:
    def __init__(self):
        self.x = []
        self.record_step = 1

    def reset(self):
        self.x = []

    def record(self, mj_data):
        self.x.append(float(mj_data.qpos[0]))


def run_variant(name, secs, vx):
    cost, gait_over = VARIANTS[name]()
    old = C.COSTS[("go2", "slow_trot")]
    old_gait = copy.deepcopy(C.GAITS["slow_trot"])
    C.COSTS[("go2", "slow_trot")] = lambda: cost
    for k, v in gait_over.items():
        setattr(C.GAITS["slow_trot"], k, v)
    try:
        spec = go2_spec()
        sim = Simulator(spec)
        mpc = LocomotionMPC(spec, gait_name="slow_trot", solve_async=False)
        mpc.set_command(np.array([vx, 0.0, 0.0]))
        rec = _XRecorder()
        res = sim.run(sim_time=secs, controller=mpc, data_recorder=rec)
        x = sim.data.qpos[0]
        z = sim.data.qpos[2]
        quatw = sim.data.qpos[3]
        xs = np.asarray(rec.x)
        k = min(2000, max(len(xs) - 1, 1))  # steady-state: last 2 s
        v_ss = (xs[-1] - xs[-k]) / (k * 1e-3) if len(xs) > k else float("nan")
        print(f"[{name}] survived {res.sim_time:.2f}/{secs}s fell={res.fell} "
              f"term='{res.termination}' x={x:.2f} "
              f"({x / max(res.sim_time, 1e-6):.3f} m/s vs {vx}, "
              f"v_ss={v_ss:.3f}) z={z:.2f} "
              f"|quat_w|={abs(quatw):.3f}", flush=True)
    finally:
        C.COSTS[("go2", "slow_trot")] = old
        C.GAITS["slow_trot"] = old_gait


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=sorted(VARIANTS))
    ap.add_argument("--secs", type=float, default=5.0)
    ap.add_argument("--vx", type=float, default=0.15)
    args = ap.parse_args()
    for name in args.variants:
        run_variant(name, args.secs, args.vx)


if __name__ == "__main__":
    main()
