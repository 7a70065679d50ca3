"""Fused Riccati sweep + alpha=1 rollout as one Pallas-Triton kernel.

The batched sweep is the QP-solve hot loop (the HPIPM role, SURVEY.md §2.3):
N sequential nodes of small (36/30-dim) factorizations. XLA runs it as a
`lax.scan` whose every step is a batched 30x30 Cholesky, triangular solves
and small matmuls, each a separate launch with its intermediates in device
memory, and the rollout as a second scan. This kernel runs the whole
backward sweep AND the affine forward rollout of one problem in one program;
the grid is the problem batch (one program per problem, no carry between
programs).

Inputs are the batch-major GN blocks the XLA Gram emits
(`solver/sqp.py::_sqp_iter`): Q (B,N,36,36), R (B,N,30,30), M (B,N,36,30),
qx (B,N,36), ru (B,N,30), P_N (B,36,36), p_N (B,36), defects (B,N,36),
dx0 (B,36). Triton tensors have power-of-two shapes and cannot be sliced,
so inside the kernel

- every x-indexed quantity is split into its q and v halves, each held in
  a 32-wide block (rows/cols 18..31 zero): P = [[Pqq, Pqv], [Pvq, Pvv]].
  The double-integrator A = [[I, hI], [0, I]], B = [[h^2/2 I_a], [h I_a]]
  then acts by block scale-adds (the math of
  `sqp._riccati_solve_structured`), with no dense A/B products;
- u-indexed quantities live in one 32-wide block (a: 0..17, f: 18..29; the
  pad diagonal of Quu is 1 so the factorization ignores it);
- the blocks are gathered from the natural batch-major layout with masked
  loads, so there is no relayout pass in front of the kernel;
- the Cholesky factorization and the forward substitution of
  [Qux | qu] share one loop of masked rank-1 updates; the back
  substitution is a second loop; the value-function update uses the
  K-free form P <- Qxx - W^T W with W = L^{-1} Qux (fp32 dots at IEEE
  precision, no TF32).

The gains go to device memory once (the rollout re-reads them after a
block barrier); only (dX1, dU1) are needed downstream. Everything is fp32.
Wired into `TrajOptSolver` as riccati_mode="triton" through a custom_vmap:
unbatched solves keep the XLA scans.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NX = 36           # state dim
NQ = 18           # q (and v) half of the state; also the acceleration inputs
NU = 30           # input dim
T = 32            # block width inside the kernel
_HI = jax.lax.Precision.HIGHEST


def _kernel(h, lm, N, interpret,
            q_ref, r_ref, m_ref, qx_ref, ru_ref, pn_ref, pnv_ref, d_ref,
            dx0_ref, k_ref, kff_ref, dx_ref, du_ref):
    b = pl.program_id(0)
    hh = 0.5 * h * h
    f32 = jnp.float32
    r = jax.lax.broadcasted_iota(jnp.int32, (T, T), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (T, T), 1)
    rv = jax.lax.broadcasted_iota(jnp.int32, (T,), 0)

    def gather(ref, lead, base, rs, cs, nr, nc):
        """(T, T) block: element (i, j) = flat[base + i*rs + j*cs] for
        i < nr, j < nc, else 0."""
        mask = (r < nr) & (c < nc)
        idx = jnp.where(mask, base + r * rs + c * cs, 0)
        return plgpu.load(ref.at[(*lead, idx)], mask=mask, other=0.0)

    def gather_vec(ref, lead, base, n):
        mask = rv < n
        idx = jnp.where(mask, base + rv, 0)
        return plgpu.load(ref.at[(*lead, idx)], mask=mask, other=0.0)

    def split_mat(ref, lead, ld):
        """q/v blocks of a row-major (36, 36) matrix with leading dim ld."""
        return (gather(ref, lead, 0, ld, 1, NQ, NQ),
                gather(ref, lead, NQ, ld, 1, NQ, NQ),
                gather(ref, lead, NQ * ld, ld, 1, NQ, NQ),
                gather(ref, lead, NQ * ld + NQ, ld, 1, NQ, NQ))

    def matvec(A, x):
        return jnp.sum(A * x[None, :], axis=1)

    def row(A, k):
        return jnp.sum(jnp.where(r == k, A, 0.0), axis=0)

    def pick(v, k):
        return jnp.sum(jnp.where(rv == k, v, 0.0))

    def gram(X, Y):
        # X^T Y over the u rows
        return jax.lax.dot_general(X, Y, (((0,), (0,)), ((), ())),
                                   precision=_HI, preferred_element_type=f32)

    eye = r == c
    quu_diag = jnp.where(eye & (r < NU), lm, 0.0) + jnp.where(
        eye & (r >= NU), 1.0, 0.0)

    def node(t, carry):
        Pqq, Pqv, Pvq, Pvv, pq, pv = carry
        n = N - 1 - t
        lead = (b, n)
        Qqq, Qqv, Qvq, Qvv = split_mat(q_ref, lead, NX)
        Ruu = gather(r_ref, lead, 0, NU, 1, NU, NU)
        # Qux rows are u, columns x: Qux[u, x] = M[x, u]
        MTq = gather(m_ref, lead, 0, 1, NU, NU, NQ)
        MTv = gather(m_ref, lead, NQ * NU, 1, NU, NU, NQ)
        qxq = gather_vec(qx_ref, lead, 0, NQ)
        qxv = gather_vec(qx_ref, lead, NQ, NQ)
        ru = gather_vec(ru_ref, lead, 0, NU)
        dq = gather_vec(d_ref, lead, 0, NQ)
        dv = gather_vec(d_ref, lead, NQ, NQ)

        # products with the double-integrator A/B as block scale-adds
        PAqv = h * Pqq + Pqv                  # (P A)[:, v] rows q
        PAvv = h * Pvq + Pvv                  # (P A)[:, v] rows v
        Xqq = Qqq + Pqq                       # Qxx = Q + A^T P A
        Xqv = Qqv + PAqv
        Xvq = Qvq + h * Pqq + Pvq
        Xvv = Qvv + h * PAqv + PAvv
        PBq = hh * Pqq + h * Pqv              # P B_a, rows q
        PBv = hh * Pvq + h * Pvv              # P B_a, rows v
        Quu = Ruu + quu_diag + hh * PBq + h * PBv
        Wq = MTq + hh * Pqq + h * Pvq         # Qux = M^T + B^T P A
        Wv = MTv + hh * PAqv + h * PAvv
        Pdq = matvec(Pqq, dq) + matvec(Pqv, dv) + pq
        Pdv = matvec(Pvq, dq) + matvec(Pvv, dv) + pv
        qxq = qxq + Pdq
        qxv = qxv + h * Pdq + Pdv
        wf = ru + hh * Pdq + h * Pdv

        def factor(k, fc):
            # right-looking Cholesky column k, fused with the forward
            # substitution W = L^{-1} [Qux | qu] on row k
            A, Lm, Wq, Wv, wf, rsd = fc
            colk = jnp.sum(jnp.where(c == k, A, 0.0), axis=1)
            rs = jax.lax.rsqrt(jnp.maximum(pick(colk, k), 1e-30))
            lk = jnp.where(rv >= k, colk * rs, 0.0)
            lb = jnp.where(rv > k, lk, 0.0)
            A = A - lb[:, None] * lb[None, :]
            Lm = jnp.where(c == k, lk[:, None], Lm)
            rsd = jnp.where(rv == k, rs, rsd)
            yq = row(Wq, k) * rs
            yv = row(Wv, k) * rs
            yf = pick(wf, k) * rs
            Wq = jnp.where(r == k, yq[None, :], Wq - lb[:, None] * yq[None, :])
            Wv = jnp.where(r == k, yv[None, :], Wv - lb[:, None] * yv[None, :])
            wf = jnp.where(rv == k, yf, wf - lb * yf)
            return A, Lm, Wq, Wv, wf, rsd

        zeros = jnp.zeros((T, T), f32)
        _, Lm, Wq, Wv, wf, rsd = jax.lax.fori_loop(
            0, NU, factor, (Quu, zeros, Wq, Wv, wf, jnp.zeros((T,), f32)))

        # value function: P <- Qxx - W^T W, p <- qx' - W^T wf (symmetrized)
        Xqq = Xqq - gram(Wq, Wq)
        Xqv = Xqv - gram(Wq, Wv)
        Xvq = Xvq - gram(Wv, Wq)
        Xvv = Xvv - gram(Wv, Wv)
        pq = qxq - jnp.sum(Wq * wf[:, None], axis=0)
        pv = qxv - jnp.sum(Wv * wf[:, None], axis=0)
        Pqq = 0.5 * (Xqq + Xqq.T)
        Pqv = 0.5 * (Xqv + Xvq.T)
        Pvq = Pqv.T
        Pvv = 0.5 * (Xvv + Xvv.T)

        def back(s, bc):
            # back substitution Z = L^{-T} W, row k, in place
            Zq, Zv, zf = bc
            k = NU - 1 - s
            rk = pick(rsd, k)
            zq = row(Zq, k) * rk
            zv = row(Zv, k) * rk
            zk = pick(zf, k) * rk
            lrow = jnp.where(rv < k, row(Lm, k), 0.0)      # L[k, i], i < k
            Zq = jnp.where(r == k, zq[None, :], Zq - lrow[:, None] * zq[None, :])
            Zv = jnp.where(r == k, zv[None, :], Zv - lrow[:, None] * zv[None, :])
            zf = jnp.where(rv == k, zk, zf - lrow * zk)
            return Zq, Zv, zf

        Zq, Zv, zf = jax.lax.fori_loop(0, NU, back, (Wq, Wv, wf))
        plgpu.store(k_ref.at[b, n, 0], -Zq)
        plgpu.store(k_ref.at[b, n, 1], -Zv)
        plgpu.store(kff_ref.at[b, n], -zf)
        return Pqq, Pqv, Pvq, Pvv, pq, pv

    P0 = split_mat(pn_ref, (b,), NX)
    p0 = (gather_vec(pnv_ref, (b,), 0, NQ), gather_vec(pnv_ref, (b,), NQ, NQ))
    jax.lax.fori_loop(0, N, node, (*P0, *p0))
    if not interpret:
        plgpu.debug_barrier()    # gains written above are re-read below

    def rollout(n, rc):
        dxq, dxv = rc
        Kq = plgpu.load(k_ref.at[b, n, 0])
        Kv = plgpu.load(k_ref.at[b, n, 1])
        du = plgpu.load(kff_ref.at[b, n]) + matvec(Kq, dxq) + matvec(Kv, dxv)
        plgpu.store(dx_ref.at[b, n, 0], dxq)
        plgpu.store(dx_ref.at[b, n, 1], dxv)
        plgpu.store(du_ref.at[b, n], du)
        dua = jnp.where(rv < NQ, du, 0.0)
        dq = gather_vec(d_ref, (b, n), 0, NQ)
        dv = gather_vec(d_ref, (b, n), NQ, NQ)
        return dxq + h * dxv + hh * dua + dq, dxv + h * dua + dv

    dx0 = (gather_vec(dx0_ref, (b,), 0, NQ), gather_vec(dx0_ref, (b,), NQ, NQ))
    dxq, dxv = jax.lax.fori_loop(0, N, rollout, dx0)
    plgpu.store(dx_ref.at[b, N, 0], dxq)
    plgpu.store(dx_ref.at[b, N, 1], dxv)


def riccati_rollout_batched(h: float, lm: float, Q, R, M, qx, ru, P_N, p_N,
                            defects, dx0, *, interpret: bool = False,
                            return_gains: bool = False):
    """Batched sweep + alpha=1 rollout. Shapes as in the module docstring.
    Returns (dX1 (B,N+1,36), dU1 (B,N,30)), plus (K (B,N,30,36),
    kff (B,N,30)) with return_gains."""
    B, N = Q.shape[0], Q.shape[1]
    dtype = Q.dtype
    f32 = jnp.float32

    def flat(x, lead):
        return x.astype(f32).reshape(x.shape[:lead] + (-1,))

    args = (flat(Q, 2), flat(R, 2), flat(M, 2), qx.astype(f32),
            ru.astype(f32), flat(P_N, 1), p_N.astype(f32),
            defects.astype(f32), dx0.astype(f32))
    Kp, kffp, dXp, dUp = pl.pallas_call(
        functools.partial(_kernel, float(h), float(lm), N, interpret),
        out_shape=[
            jax.ShapeDtypeStruct((B, N, 2, T, T), f32),
            jax.ShapeDtypeStruct((B, N, T), f32),
            jax.ShapeDtypeStruct((B, N + 1, 2, T), f32),
            jax.ShapeDtypeStruct((B, N, T), f32),
        ],
        grid=(B,),
        backend="triton",
        # one problem per 4-warp program: fastest of 1/2/4/8 warps measured
        # on an H100 at B=512, N=25
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="riccati_rollout",
    )(*args)
    dX = jnp.concatenate([dXp[..., 0, :NQ], dXp[..., 1, :NQ]], axis=-1)
    dU = dUp[..., :NU]
    out = (dX.astype(dtype), dU.astype(dtype))
    if return_gains:
        K = jnp.concatenate([Kp[..., 0, :NU, :NQ], Kp[..., 1, :NU, :NQ]],
                            axis=-1)
        out += (K.astype(dtype), kffp[..., :NU].astype(dtype))
    return out
