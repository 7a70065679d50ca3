"""Structure-exploiting linearization vs the jacfwd oracle (solver/linearize.py)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu.solver import sqp as S
from iterative_learning_nmpc_tpu.solver.linearize import (
    linearize_stages_fast,
    make_const_blocks,
)


@pytest.fixture(scope="module")
def setup():
    gait, opt, cost = get_quadruped_config("trot", "go2")
    spec = go2_spec()
    solver = S.TrajOptSolver(spec, opt, cost)
    rng = np.random.RandomState(3)
    N = solver.N
    q0 = np.asarray(spec.q_home, np.float32)
    X = np.tile(np.concatenate([q0, np.zeros(18, np.float32)])[None], (N + 1, 1))
    X[:, :36] += 0.05 * rng.randn(N + 1, 36).astype(np.float32)
    U = 0.3 * rng.randn(N, 30).astype(np.float32)
    U[:, 20::3] += 30.0  # plausible normal forces so cone hinges mix active/inactive
    cnt = (rng.rand(4, N + 1) > 0.4).astype(np.float32)
    params = S.make_params(
        solver, X[0], cnt,
        cnt_loc=0.3 * rng.randn(4, N + 1, 3).astype(np.float32),
        patch_radius=np.full((4, N + 1), 0.05, np.float32),
        restrict=1.0,
        lam_eq=0.1 * rng.randn(N, 18).astype(np.float32),
        lam_ineq=0.5 * np.abs(rng.randn(N, 36)).astype(np.float32),
    )
    return solver, jnp.asarray(X), jnp.asarray(U), params


@pytest.mark.parametrize("include_torque", [False, True])
def test_fast_linearize_matches_jacfwd(setup, include_torque):
    solver, X, U, params = setup
    w, spec = solver.weights, solver.spec
    r0, Jx0, Ju0 = jax.jit(
        lambda X, U, p: S._linearize_stages(
            spec, w, X, U, p, include_torque=include_torque)
    )(X, U, params)
    Jxc, Juc = make_const_blocks(w)
    r1, Jx1, Ju1 = jax.jit(
        lambda X, U, p: linearize_stages_fast(
            spec, w, X, U, p, Jxc, Juc, include_torque=include_torque)
    )(X, U, params)
    assert r0.shape == r1.shape and Jx0.shape == Jx1.shape and Ju0.shape == Ju1.shape
    np.testing.assert_allclose(r0, r1, atol=1e-6)
    scale = max(1.0, float(jnp.max(jnp.abs(Jx0))))
    np.testing.assert_allclose(Jx1, Jx0, atol=2e-4 * scale)
    scale_u = max(1.0, float(jnp.max(jnp.abs(Ju0))))
    np.testing.assert_allclose(Ju1, Ju0, atol=2e-4 * scale_u)


def test_fast_linearize_inside_solver(setup):
    """Solving with the fast path reproduces the AD-path solution.

    f64: the assembly is exact there (verified groupwise); in fp32 the two
    mathematically identical linearizations differ at rounding level, which
    hinge-activity flips amplify across SQP iterations."""
    solver_f32, X, U, params = setup
    with jax.enable_x64():
        gait, opt, cost = get_quadruped_config("trot", "go2")
        solver = S.TrajOptSolver(go2_spec(), opt, cost, dtype=jnp.float64)
        X64 = jnp.asarray(np.asarray(X), jnp.float64)
        U64 = jnp.asarray(np.asarray(U), jnp.float64)
        p64 = jax.tree.map(
            lambda x: jnp.asarray(np.asarray(x), jnp.float64), params
        )
        sol_ad = jax.jit(
            lambda X, U, p: solver.solve(X, U, p, 3, use_fast_linearize=False)
        )(X64, U64, p64)
        sol_fast = jax.jit(lambda X, U, p: solver.solve(X, U, p, 3))(X64, U64, p64)
        np.testing.assert_allclose(
            np.asarray(sol_fast.X), np.asarray(sol_ad.X), atol=1e-8
        )
