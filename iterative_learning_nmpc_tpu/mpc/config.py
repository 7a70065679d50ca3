"""Typed MPC configuration dataclasses + the quadruped catalog.

Mirrors the reference's two-tier config system
(`mpc_controller/config/config_abstract.py`, `config/quadruped/*.py`):
GaitConfig / MPCOptConfig / MPCCostConfig with invariant checks, resolved by
(robot, gait) factories. Solver-backend knobs that were acados/HPIPM-specific
(hpipm_mode, use_cython, recompile) are replaced by the knobs of the JAX
GN-SQP solver (penalty weights, line-search set, Levenberg regularization).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass
class GaitConfig:
    """Periodic gait description (reference `config_abstract.py:9-25`)."""

    gait_name: str
    nominal_period: float
    stance_ratio: np.ndarray
    phase_offset: np.ndarray
    nom_height: float
    step_height: float
    n_eeff: int = 4

    def __post_init__(self):
        self.stance_ratio = np.asarray(self.stance_ratio, dtype=np.float64)
        self.phase_offset = np.asarray(self.phase_offset, dtype=np.float64)
        assert np.all((0 <= self.stance_ratio) & (self.stance_ratio <= 1)), \
            "stance_ratio should be in [0,1]"
        assert np.all((0 <= self.phase_offset) & (self.phase_offset <= 1)), \
            "phase_offset should be in [0,1]"
        assert len(self.stance_ratio) == self.n_eeff
        assert len(self.phase_offset) == self.n_eeff


RICCATI_MODES = ("auto", "sequential", "triton", "associative")
LINEARIZE_MODES = ("auto", "jacfwd")
_REMOVED_MODES = {
    ("riccati_mode", "pallas"): "the Mosaic Riccati kernel was removed; use "
                                "'auto' (Triton kernel on GPU) or "
                                "'sequential'",
    ("linearize_mode", "dynjac"): "the Mosaic dynamics+Jacobian kernel was "
                                  "removed; use 'auto' or 'jacfwd'",
}


def check_solver_modes(opt) -> None:
    """Raise ValueError for an unknown or removed solver path name."""
    for field, allowed in (("riccati_mode", RICCATI_MODES),
                           ("linearize_mode", LINEARIZE_MODES)):
        value = getattr(opt, field)
        if (field, value) in _REMOVED_MODES:
            raise ValueError(f"{field}={value!r}: "
                             f"{_REMOVED_MODES[(field, value)]}")
        if value not in allowed:
            raise ValueError(f"{field}={value!r} not in {allowed}")


@dataclass
class MPCOptConfig:
    """Optimizer + controller loop configuration
    (reference `config_abstract.py:29-94` + `mpc_opt.py:8-27`)."""

    time_horizon: float = 1.0
    n_nodes: int = 25
    replanning_freq: int = 25
    Kp: float = 20.0
    Kd: float = 1.75
    # SQP iterations: steady-state (RTI-style) / first solve
    max_iter: int = 1
    max_iter_first: int = 15
    # Inner QP (augmented-Lagrangian) passes per SQP iteration: each pass
    # takes a GN step with the current inequality-hinge shifts and updates
    # the duals s <- clip(s + g, 0, s_max), exiting early once the
    # scale-normalized violation drops below qp_tol (solver/sqp.py:solve —
    # the HPIPM interior-point budget role, reference mpc_opt.py:27)
    max_qp_iter: int = 6
    # Enable per-node dt optimization (reference keeps this off by default)
    enable_time_opt: bool = False
    opt_dt_scale: Tuple[float, float] = (0.5, 1.75)
    opt_peak: bool = True
    warm_start_sol: bool = True
    torque_limit: bool = True
    # Keep the torque-limit hinge rows in the QP linearization (exact SQP) or
    # only in the merit function (inexact/RTI). Since the dynamics residual
    # shares the RNEA pass, keeping them costs nothing extra.
    torque_limit_in_qp: bool = True
    mu: float = 0.7
    nlp_tol: float = 1.0e-1
    # Inner-loop exit tolerance on the scale-normalized max inequality
    # violation (cone / per-foot gravity share, torque / limit, patch / 10 cm
    # — solver/sqp.py _ineq_scales): 1e-2 means cone <= ~0.4 N on Go2
    qp_tol: float = 1.0e-2
    # --- solver knobs (replace hpipm_mode/use_cython/recompile) ---
    # Levenberg-Marquardt regularization added to the input-Hessian blocks
    lm_reg: float = 1.0e-6
    # Parallel line-search candidates (evaluated simultaneously — ONE fused
    # FK/RNEA launch covers every candidate's merit cost AND the AL dual
    # updates). Full set for cold/first solves; warm-started RTI solves use
    # the steady set. acados' SQP_RTI takes the pure full step
    # (`real_time_it`, reference solver.py:68-72) — ls_alphas_steady=(1.0,)
    # reproduces that and is ~10% faster — but the 0.25 fallback is
    # LOAD-BEARING for recovery when the expert takes over from a degraded
    # state (SafeDAgger takeover: without it the combined-controller e2e
    # rollout crashes; measured in tests/test_pipeline_e2e.py), so the
    # robust set is the default.
    ls_alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1)
    ls_alphas_steady: Tuple[float, ...] = (1.0, 0.25)
    # Riccati backward sweep:
    #   "auto"        -> "triton" on GPU, "sequential" elsewhere
    #   "sequential"  -> lax.scan of structured/generic steps (backward-stable)
    #   "triton"      -> batched solves run the sweep + alpha=1 rollout as one
    #                    Pallas-Triton kernel launch (ops/riccati_triton.py);
    #                    unbatched solves keep the scan via custom_vmap
    #   "associative" -> parallel-in-time log-depth scan (long horizons,
    #                    ~1e-2 relative fp32 accuracy; exact in f64)
    riccati_mode: str = "auto"
    # Stage linearization: "jacfwd" (66 forward tangents through the
    # residual stack) is the only path; XLA fuses the tangent chain.
    linearize_mode: str = "auto"
    # Penalty weights for the constraint residuals (quadratic / AL)
    w_dyn: float = 1.0e3        # centroidal dynamics consistency (6,)
    w_contact: float = 1.0e3    # active-contact foot velocity pinning (4,3)
    w_cone: float = 1.0e1       # friction-cone hinge
    w_swing_height: float = 1.0e3  # swing foot above ground hinge
    w_torque: float = 1.0e0     # torque-limit hinge
    w_patch: float = 1.0e6      # contact-patch-radius hinge (restricted mode;
                                # cm-scale violations need a stiff penalty to
                                # dominate the m-scale tracking pull)

    def __post_init__(self):
        assert len(self.opt_dt_scale) == 2
        assert self.mu > 0
        check_solver_modes(self)

    def get_dt_nodes(self) -> float:
        return round(self.time_horizon / self.n_nodes, 4)

    def get_dt_bounds(self) -> Tuple[float, float]:
        dt = self.get_dt_nodes()
        return (round(dt * self.opt_dt_scale[0], 4), round(dt * self.opt_dt_scale[1], 4))

    @property
    def replan_steps_1khz(self) -> int:
        return int(1.0 / (self.replanning_freq * 1.0e-3))


@dataclass
class MPCCostConfig:
    """Weight tables (reference `config_abstract.py:98-146`)."""

    robot_name: str
    gait_name: str
    W_e_base: np.ndarray
    W_base: np.ndarray
    W_joint: np.ndarray
    W_e_joint: np.ndarray
    W_acc: np.ndarray
    W_swing: np.ndarray
    W_cnt_f_reg: np.ndarray
    W_foot_pos_constr_stab: np.ndarray
    W_foot_displacement: np.ndarray
    cnt_radius: float
    time_opt: float
    reg_eps: float
    reg_eps_e: float

    def __post_init__(self):
        for name in (
            "W_e_base", "W_base", "W_joint", "W_e_joint", "W_acc", "W_swing",
            "W_cnt_f_reg", "W_foot_pos_constr_stab", "W_foot_displacement",
        ):
            setattr(self, name, np.asarray(getattr(self, name), dtype=np.float64))
        assert len(self.W_e_base) == 12, "W_e_base must be of shape 12"
        assert len(self.W_base) == 12, "W_base must be of shape 12"
        assert len(self.W_acc) == 12, "W_acc must be of shape 12"
        assert self.W_joint.shape == (24,)
        assert self.W_e_joint.shape == (24,)
        assert len(self.W_swing) == len(self.W_cnt_f_reg)
        assert len(self.W_swing) == len(self.W_foot_pos_constr_stab)
        assert self.W_cnt_f_reg.shape[-1] == 3


# ---------------------------------------------------------------------------
# Gait catalog (reference `config/quadruped/mpc_gait.py:15-86`)
# ---------------------------------------------------------------------------

def _gait(name, period, stance, offset, nom_h, step_h):
    return GaitConfig(
        gait_name=name,
        nominal_period=period,
        stance_ratio=np.array(stance),
        phase_offset=np.array(offset),
        nom_height=nom_h,
        step_height=step_h,
    )


GAITS = {
    "trot": _gait("trot", 0.5, [0.5] * 4, [0.5, 0.0, 0.0, 0.5], 0.30, 0.05),
    "slow_trot": _gait("slow_trot", 1.0, [0.63] * 4, [0.5, 0.0, 0.0, 0.5], 0.32, 0.065),
    "jump": _gait("jump", 50.0, [0.4] * 4, [0.0] * 4, 0.3, 0.05),
    "crawl": _gait("crawl", 1.0, [0.75] * 4, [0.0, 0.25, 0.5, 0.75], 0.3, 0.05),
    "pace": _gait("pace", 0.5, [0.6] * 4, [0.0, 0.5, 0.5, 0.0], 0.30, 0.05),
    "bound": _gait("bound", 0.5, [0.6] * 4, [0.5, 0.5, 0.0, 0.0], 0.30, 0.05),
}


# ---------------------------------------------------------------------------
# Cost catalog (reference `config/quadruped/mpc_cost.py`)
# ---------------------------------------------------------------------------

_HIP_SHOULDER_ELBOW = [15.0, 5.0, 1.0]


def _go2_trot_cost() -> MPCCostConfig:
    return MPCCostConfig(
        robot_name="go2",
        gait_name="trot",
        # base-z running weight raised vs the reference table (1e2 there):
        # with soft contact/dynamics penalties the height needs a stronger
        # direct incentive than acados' hard-constrained formulation did.
        W_base=np.array([
            1e3, 3e3, 2e3,
            5e2, 5e2, 5e2,
            5e2, 1e1, 1e0,
            1e0, 2e1, 1e1,
        ]),
        W_e_base=np.array([
            1e1, 1e1, 1e3,
            1e1, 1e2, 1e2,
            5e2, 5e2, 1e3,
            1e1, 1e2, 1e2,
        ]),
        W_joint=np.array(_HIP_SHOULDER_ELBOW * 4 + [0.03] * 12) * 5.0,
        W_e_joint=np.array(_HIP_SHOULDER_ELBOW * 4 + [0.1] * 12) * 1.0,
        W_acc=np.array(_HIP_SHOULDER_ELBOW * 4) * 5.0e-4,
        W_swing=np.array([2e4] * 4),
        W_cnt_f_reg=np.array([[0.01, 0.01, 0.05]] * 4),
        W_foot_pos_constr_stab=np.array([5e1] * 4),
        W_foot_displacement=np.array([1e3]),
        cnt_radius=0.015,
        time_opt=1.0e4,
        reg_eps=1.0e-6,
        reg_eps_e=1.0e-5,
    )


def _go2_slow_trot_cost() -> MPCCostConfig:
    """Slow trot (1.0 s period, 0.63 stance; GAITS['slow_trot'] timing from
    the reference, `config/quadruped/mpc_gait.py`).

    DEVIATION from the reference's Go2SlowTrotCost table
    (`config/quadruped/mpc_cost.py:90-128`): that table zeroes every xy
    position AND vx/vy velocity weight — in its hard-constrained acados
    formulation the Raibert footsteps alone drag the base, but under this
    framework's soft-contact costs it yields zero velocity tracking
    (measured -0.02 m/s at a 0.15 m/s command, scripts/exp_slow_trot.py v0).
    The trot weight table transfers to the slow timing and tracks: measured
    8 s closed-loop at 0.15 m/s -> v_ss = 0.151 m/s, no fall, z = 0.29
    (exp_slow_trot v3 grid winner; raising vx weights only undershoots:
    v8 0.144, v9 0.134). Requires the 2-decimal v_des rounding in
    mpc/controller.py — the reference's 1-decimal rounding quantizes a
    0.15 m/s goal to 0.2 and was the dominant tracking error."""
    cfg = _go2_trot_cost()
    cfg.gait_name = "slow_trot"
    return cfg


def _go2_pace_cost() -> MPCCostConfig:
    """Pace gait (lateral leg pairs, GAITS['pace'] bitmap). The trot table
    transfers directly: closed-loop validated at 0.3 m/s over 3 s (mean vx
    0.31, height 0.275 m, |roll| < 0.01, |pitch| < 0.03 —
    tests/test_gait_walking.py). The reference ships NO pace cost table
    (`config/quadruped/mpc_cost.py:131-145` is trot/slow-trot only), so this
    exceeds reference parity and shows the formulation generalizes beyond
    the one tuned operating point."""
    cfg = _go2_trot_cost()
    cfg.gait_name = "pace"
    return cfg


def _go2_crawl_cost() -> MPCCostConfig:
    """Crawl gait (one swing foot at a time, 0.75 stance ratio). With the
    trot velocity weight the optimizer trades commanded speed for force
    regularization across the 3 stance feet (measured 0.17 at 0.2 m/s);
    raising the vx tracking weight recovers it (0.19 at 0.2 m/s, height
    0.286 m, |roll| < 0.03 — tests/test_gait_walking.py)."""
    cfg = _go2_trot_cost()
    cfg.gait_name = "crawl"
    W = cfg.W_base.copy()
    W[6] = 1.5e3
    cfg.W_base = W
    return cfg


def _solo12_trot_cost() -> MPCCostConfig:
    """Solo12 trot, tuned for the ~2.5 kg robot (not a scaled Go2 clone):
    - force regularization 6x stiffer (per-foot gravity share is ~6 N vs
      ~37 N on Go2 — equal-relative regularization needs higher weight),
    - acceleration weight halved (light limbs swing faster),
    - vx tracking weight 3x (the light robot otherwise trades speed for
      force regularization: measured 0.19 -> with this table the tracking
      deficit at 0.25 m/s shrinks while the 8 N push recovery keeps roll
      under 0.05 rad — tests/test_solo12_closed_loop.py push-recovery test).
    Gait geometry + PD gains scale in get_quadruped_config."""
    cfg = _go2_trot_cost()
    cfg.robot_name = "solo12"
    W = cfg.W_base.copy()
    W[6] = 1.5e3
    cfg.W_base = W
    cfg.W_cnt_f_reg = np.array([[0.06, 0.06, 0.3]] * 4)
    cfg.W_acc = np.array(_HIP_SHOULDER_ELBOW * 4) * 2.0e-4
    return cfg


def _go2_bound_cost() -> MPCCostConfig:
    """Bound gait (front/rear leg pairs, GAITS['bound'] bitmap, 0.6 stance
    so the pairs overlap — no flight phase). The trot table transfers:
    closed-loop validated at 0.3 m/s over 3 s (mean vx 0.299, height
    0.278 m, |roll| < 0.01, |pitch| < 0.12 rad — the fore-aft rocking is
    the gait, tests/test_gait_walking.py). The reference ships NO bound
    table (`config/quadruped/mpc_cost.py:131-145` is trot/slow-trot only)."""
    cfg = _go2_trot_cost()
    cfg.gait_name = "bound"
    return cfg


COSTS = {
    ("go2", "trot"): _go2_trot_cost,
    ("go2", "slow_trot"): _go2_slow_trot_cost,
    ("go2", "pace"): _go2_pace_cost,
    ("go2", "crawl"): _go2_crawl_cost,
    ("go2", "bound"): _go2_bound_cost,
    ("solo12", "trot"): _solo12_trot_cost,
}


import copy


def get_quadruped_config(gait_name: str, robot_name: str):
    """(gait, opt, cost) factory — reference `config/quadruped/utils.py:8-17`.

    The reference catalog is Go2-only; for Solo12 (a ~2.5 kg robot with
    2.7 Nm actuators and ~0.22 m standing height) the gait geometry and PD
    gains scale down.
    """
    gait = GAITS.get(gait_name.lower())
    if gait is None:
        raise ValueError(f"{gait_name} not available.")
    cost_fn = COSTS.get((robot_name.lower(), gait_name.lower()))
    if cost_fn is None:
        raise ValueError(f"Cost config: {gait_name} for {robot_name} not available.")
    gait = copy.deepcopy(gait)
    opt = MPCOptConfig()
    if robot_name.lower() == "solo12":
        gait.nom_height = 0.22
        gait.step_height = min(gait.step_height, 0.04)
        opt.Kp = 6.0
        opt.Kd = 0.3
    return gait, opt, cost_fn()
