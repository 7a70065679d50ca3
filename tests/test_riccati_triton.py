"""Triton Riccati sweep + rollout kernel (ops/riccati_triton.py) in Pallas
interpret mode against the XLA structured scans, its wiring into the
solver, and its lowering for the GPU (Triton IR) — all on the CPU."""
import copy
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from iterative_learning_nmpc_tpu.ops.riccati_triton import (
    riccati_rollout_batched,
)
from iterative_learning_nmpc_tpu.solver import sqp as S

H, LM = 0.04, 1e-6


def _blocks(B, N, seed):
    rng = np.random.default_rng(seed)

    def spd(lead, n):
        a = rng.normal(size=lead + (n + 8, n)).astype(np.float32)
        return (np.einsum("...ri,...rj->...ij", a, a) / (n + 8)
                + np.eye(n, dtype=np.float32))

    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (spd((B, N), 36), spd((B, N), 30), 0.1 * f(B, N, 36, 30),
            f(B, N, 36), f(B, N, 30), spd((B,), 36), f(B, 36),
            0.01 * f(B, N, 36), 0.01 * f(B, 36))


def _xla(Q, R, M, qx, ru, P_N, p_N, d, dx0):
    K, kff = S._riccati_solve_structured(H, Q, R, M, qx, ru, P_N, p_N, d,
                                         jnp.float32(LM))
    dX, dU = S._forward_delta_structured(H, K, kff, d, dx0, jnp.float32(1.0))
    return dX, dU, K, kff


@pytest.mark.parametrize("B, N", [(1, 3), (3, 5), (5, 2)])
def test_kernel_matches_structured_sweep(B, N):
    blocks = _blocks(B, N, seed=B * 10 + N)
    got = jax.jit(lambda *a: riccati_rollout_batched(
        H, LM, *a, interpret=True, return_gains=True))(*blocks)
    ref = jax.jit(jax.vmap(_xla))(*blocks)
    shapes = [(B, N + 1, 36), (B, N, 30), (B, N, 30, 36), (B, N, 30)]
    for name, a, b, shape in zip(("dX1", "dU1", "K", "kff"), got, ref,
                                 shapes):
        assert a.shape == shape, name
        err = float(jnp.max(jnp.abs(a - b) / (1.0 + jnp.abs(b))))
        assert err <= 1e-4, (name, err)


def test_solver_triton_mode_matches_sequential(go2):
    """riccati_mode="triton": a vmapped RTI solve runs the kernel (interpret
    mode off the GPU) and reproduces the XLA sequential solve; an
    unbatched solve takes the scan path of the custom_vmap."""
    from __graft_entry__ import _flagship

    solver, X, U, params = _flagship()
    opt = copy.deepcopy(solver.opt)
    opt.riccati_mode = "triton"
    st = S.TrajOptSolver(solver.spec, opt, solver.cost)
    B = 2
    rng = np.random.default_rng(0)
    pb = jax.tree.map(lambda x: np.stack([np.asarray(x)] * B), params)
    pb = dataclasses.replace(pb, x0=pb.x0 + 1e-3 * rng.normal(
        size=pb.x0.shape).astype(np.float32))
    Xb = np.stack([np.asarray(X)] * B)
    Xb[:, 0] = pb.x0
    Ub = np.stack([np.asarray(U)] * B)
    # converge with the reference path, then compare one RTI step
    conv = jax.jit(jax.vmap(lambda x, u, p: solver.solve(x, u, p, 10)))(
        Xb, Ub, pb)
    pc = dataclasses.replace(pb, lam_ineq=conv.lam_ineq)
    step = lambda s: jax.jit(jax.vmap(lambda x, u, p: s.solve(x, u, p, 1)))(
        conv.X, conv.U, pc)
    a, b = step(st), step(solver)
    err = float(jnp.max(jnp.abs(a.U - b.U) / (1.0 + jnp.abs(b.U))))
    assert err <= 1e-4, err
    one = jax.jit(lambda x, u, p: st.solve(x, u, p, 1))(
        conv.X[0], conv.U[0], jax.tree.map(lambda x: x[0], pc))
    ref = jax.jit(lambda x, u, p: solver.solve(x, u, p, 1))(
        conv.X[0], conv.U[0], jax.tree.map(lambda x: x[0], pc))
    np.testing.assert_allclose(np.asarray(one.U), np.asarray(ref.U),
                               rtol=1e-5, atol=1e-5)


def test_kernel_lowers_to_triton_for_cuda():
    """The kernel lowers to a Triton custom call at the production shape
    (B=512, N=25) without a GPU present."""
    B, N = 512, 25
    sd = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    args = (sd(B, N, 36, 36), sd(B, N, 30, 30), sd(B, N, 36, 30),
            sd(B, N, 36), sd(B, N, 30), sd(B, 36, 36), sd(B, 36),
            sd(B, N, 36), sd(B, 36))
    lowered = jax.jit(lambda *a: riccati_rollout_batched(H, LM, *a)).trace(
        *args).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert text.count("__gpu$xla.gpu.triton") == 1
