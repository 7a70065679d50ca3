"""Associative-scan (parallel-in-time) Riccati sweep.

The LQR value recursion composes affine-quadratic conditional value
functions, which is an ASSOCIATIVE operation (Sarkka & Garcia-Fernandez,
"Temporal Parallelization of Dynamic Programming"): the backward sweep
becomes a `jax.lax.associative_scan` of depth ceil(log2 N) instead of N
sequential steps, and the feedback gains then come out of ONE node-parallel
batched factorization. This is the horizon-axis parallelism called for in
SURVEY.md §5 (the OCP-horizon analogue of sequence parallelism) — at N=25
it trades ~2x FLOPs for ~5x less sequential depth; for long-horizon variants
(N >= 100) it is the difference between latency- and throughput-bound.

Element parameterization for the conditional value function of a segment
i -> j (max-plus "Gaussian" kernel form):

  V(x_i, x_j) = 1/2 (x_j - A x_i - b)^T C^+ (x_j - A x_i - b)
                + 1/2 x_i^T J x_i - eta^T x_i   (+ const)

Composition (never needs C^{-1}, so rank-deficient C from B R^{-1} B^T is
fine):

  D    = (I + C_i J_j)^{-1}
  A_ij = A_j D A_i
  b_ij = A_j D (b_i + C_i eta_j) + b_j
  C_ij = A_j D C_i A_j^T + C_j
  eta_ij = A_i^T D^{-T-free form} (eta_j - J_j b_i) + eta_i
  J_ij = A_i^T (I + J_j C_i)^{-1} J_j A_i + J_i

Cross terms (M) are eliminated by the standard substitution
u = w - R^{-1} M^T x before building elements.

Validated bit-for-bit (f64) and to ~1e-2 relative (fp32, OCP conditioning)
against the sequential `_riccati_solve` oracle in
tests/test_parallel_riccati.py.

STATUS: each composition costs a batched nonsymmetric 36x36 LU solve, so
the sequential sweep is the default; this scan is a correctness-validated
option (MPCOptConfig.riccati_mode="associative") for horizons long enough
that log depth pays. Its speed on the GPU is not measured yet
(scripts/bench_long_horizon.py compares the modes at N=25/100).

N=100 NUMERICS (tests/test_parallel_riccati.py::
test_long_horizon_n100_modes_agree): in f64 the composition matches the
sequential sweep to <1e-6 relative through 2 full SQP iterations on the
production OCP; in fp32 the 4 s-horizon conditioning amplifies composition
round-off to ~1e-1 after 2 iterations (line-search bifurcation included) —
use f64 (or the sequential sweep) when long-horizon fp32 trajectories must
match the RTI production path.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _compose(e1, e2):
    """Compose element e1 (earlier segment) with e2 (later segment)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    nx = A1.shape[-1]
    I = jnp.eye(nx, dtype=A1.dtype)
    # D = (I + C1 J2)^{-1}
    M1 = I + C1 @ J2
    A2D = A2 @ jnp.linalg.solve(M1, I)
    A12 = A2D @ A1
    b12 = A2D @ (b1 + C1 @ eta2) + b2
    C12 = A2D @ C1 @ A2.T + C2
    # (I + J2 C1)^{-1}
    M2 = I + J2 @ C1
    S = jnp.linalg.solve(M2, jnp.concatenate([ (eta2 - J2 @ b1)[:, None], J2 @ A1], axis=1))
    eta12 = A1.T @ S[:, 0] + eta1
    J12 = A1.T @ S[:, 1:] + J1
    J12 = 0.5 * (J12 + J12.T)
    return A12, b12, C12, eta12, J12


def parallel_riccati(
    A, B, Q, R, M, qx_vec, ru_vec, P_N, p_N, defects, lm_reg
) -> Tuple[jax.Array, jax.Array]:
    """Drop-in replacement for solver.sqp._riccati_solve (same signature).

    A, B: constant dynamics (nx, nx), (nx, nu).
    Q/R/M/qx_vec/ru_vec/defects: per-node (N, ...) GN blocks.
    Returns (K, kff) per node.
    """
    N, nx = Q.shape[0], Q.shape[1]
    nu = R.shape[1]
    dtype = Q.dtype
    eye_u = jnp.eye(nu, dtype=dtype)
    R_reg = R + lm_reg * eye_u

    # eliminate cross terms: u = w - R^{-1} M^T x
    RinvMt = jnp.linalg.solve(R_reg, jnp.swapaxes(M, 1, 2))      # (N, nu, nx)
    Rinvr = jnp.linalg.solve(R_reg, ru_vec[..., None])[..., 0]   # (N, nu)
    A_t = A[None] - jnp.einsum("ij,njk->nik", B, RinvMt)         # (N, nx, nx)
    Q_t = Q - jnp.einsum("nij,njk->nik", M, RinvMt)
    Q_t = 0.5 * (Q_t + jnp.swapaxes(Q_t, 1, 2))
    q_t = qx_vec - jnp.einsum("nij,nj->ni", M, Rinvr)

    # per-node elements: C_k = B R_k^{-1} B^T  (R varies per node)
    RinvBt = jnp.linalg.solve(R_reg, jnp.broadcast_to(B.T, (N, nu, nx)))
    C_el = jnp.einsum("ij,njk->nik", B, RinvBt)                  # (N, nx, nx)
    b_el = defects - jnp.einsum("ij,nj->ni", B, Rinvr)           # (N, nx)
    eta_el = -q_t                                                # (N, nx)
    J_el = Q_t

    # terminal element
    zero = jnp.zeros((1, nx, nx), dtype)
    elems = (
        jnp.concatenate([A_t, zero], axis=0),
        jnp.concatenate([b_el, jnp.zeros((1, nx), dtype)], axis=0),
        jnp.concatenate([C_el, zero], axis=0),
        jnp.concatenate([eta_el, -p_N[None]], axis=0),
        jnp.concatenate([J_el, P_N[None]], axis=0),
    )

    # suffix compositions: result[k] = e_k * e_{k+1} * ... * e_N.
    # associative_scan(reverse=True) feeds the combine as (later-suffix,
    # earlier-element) — swap so _compose sees (earlier, later).
    composed = jax.lax.associative_scan(
        lambda a, b: jax.vmap(_compose)(b, a), elems, reverse=True, axis=0
    )
    J_all = composed[4]
    eta_all = composed[3]
    # value at node k+1 comes from the suffix starting at k+1
    P_next = J_all[1:]            # (N, nx, nx): P_{k+1} for k = 0..N-1
    p_next = -eta_all[1:]         # (N, nx)

    # node-parallel gains (cholesky over the node batch in one shot)
    BtP = jnp.einsum("ji,njk->nik", B, P_next)                   # (N, nu, nx)
    Quu = R_reg + jnp.einsum("nij,jk->nik", BtP, B)
    Qux = jnp.einsum("nij,njk->nik", BtP, A_t)
    # with the tilde substitution the 'w' linear cost term is unchanged (= r)
    qu = (
        ru_vec
        + jnp.einsum("nij,nj->ni", BtP, defects)
        + jnp.einsum("ji,nj->ni", B, p_next)
    )
    rhs = jnp.concatenate([Qux, qu[..., None]], axis=2)
    L = jnp.linalg.cholesky(Quu)
    sol = jax.scipy.linalg.cho_solve((L, True), rhs)
    K_w = -sol[:, :, :nx]
    kff = -sol[:, :, nx]
    K = K_w - RinvMt
    return K, kff
