"""Distributed Level-3 BLAS over a mesh axis (the cuMultiGPU BLAS tier).

Rebuild of the reference's multi-GPU BLAS (reference cuMultiGPUSgemm
blas/sgemm.c:432-566, cuMultiGPUSsyrk ssyrk.c:214+, cuMultiGPUStrmm): there,
the output matrix is tiled and each tile becomes a task closure round-
robined over per-GPU worker threads, with operand panels streamed over PCIe
(background_sgemm sgemm.c:211-430). Here the output is ROW-SHARDED over the
mesh axis and each device computes its stripe in one SPMD program:

  gemm_dist   C rows sharded, op(A) rows sharded to match, op(B)
              replicated → pure-local GEMM, zero collectives (the
              reference streams k-panels instead; device-resident
              operands make that machinery unnecessary, SURVEY.md §2.5)
  syrk_dist   A rows sharded; ONE all_gather supplies the transposed
              operand; triangle-only stores preserved per stripe
  trmm_dist   triangular operand replicated (it is read-only and
              triangular — the reference also broadcasts it per task)
  herk_dist   Hermitian-rank-k analog of syrk_dist (reference
              cuMultiGPUCherk/Zherk, include/blas.h:275-287)
  trsm_dist   general triangular solve, all side/uplo/trans/diag combos
              (reference cuMultiGPUStrsm..Ztrsm, include/blas.h:338-362):
              the INDEPENDENT dimension of B is sharded (columns for a
              left solve, rows for a right solve) so every device runs a
              fully local solve on its stripe — zero collectives, the
              mesh-idiomatic version of the reference's per-tile tasks

These favor simplicity over peak scaling: the output-stripe decomposition
is exactly the reference's strategy (§2.4 "multi-GPU data parallel over
output tiles").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cholesky_tpu import config
from cholesky_tpu.ops import blas_ref
from cholesky_tpu.types import (
    norm_side, norm_trans, norm_uplo, Side, Trans, Uplo,
)


def _round_up(x, m):
    return -(-x // m) * m


def _local_mm(a, b):
    """Per-device matmul: a full-precision XLA matmul (cuBLAS), the same
    GEMM the single-device tier runs (reference bar: the multiGPU tier
    reuses the GPU kernels, spotrf.c:400-468)."""
    return jnp.matmul(a, b, precision=config.matmul_precision)


def _pad_rows(X, rows):
    return X if X.shape[0] == rows else jnp.pad(
        X, ((0, rows - X.shape[0]), (0, 0)))


def gemm_dist(transa, transb, alpha, A, B, beta, C, mesh: Mesh,
              axis: str = "d"):
    """C := alpha·op(A)·op(B) + beta·C with C row-sharded over the axis."""
    oA = blas_ref.op(A, transa)
    oB = blas_ref.op(B, transb)
    m = oA.shape[0]
    p = mesh.shape[axis]
    mp = _round_up(m, p)
    oAp, Cp = _pad_rows(oA, mp), _pad_rows(C, mp)

    def body(a_loc, b_full, c_loc):
        out = _local_mm(a_loc, b_full)
        return (alpha * out + beta * c_loc).astype(c_loc.dtype)

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(axis, None), P(), P(axis, None)),
                       out_specs=P(axis, None))
    return fn(oAp, oB, Cp)[:m]


def syrk_dist(uplo, trans, alpha, A, beta, C, mesh: Mesh, axis: str = "d"):
    """Triangle-only C := alpha·A·Aᵀ + beta·C, C row-sharded; one
    all_gather supplies the transposed operand."""
    uplo = norm_uplo(uplo)
    X = blas_ref.op(A, trans)            # (n, k)
    n = X.shape[0]
    p = mesh.shape[axis]
    npd = _round_up(n, p)
    # C is square: pad BOTH dims so the local stripe matches the (rows_per,
    # npd) gathered product (rows-only padding left c_loc at n columns)
    Xp = _pad_rows(X, npd)
    Cp = C if npd == n else jnp.pad(C, ((0, npd - n), (0, npd - n)))
    rows_per = npd // p

    def body(x_loc, c_loc):
        me = lax.axis_index(axis)
        x_full = lax.all_gather(x_loc, axis).reshape(npd, X.shape[1])
        prod = _local_mm(x_loc, x_full.T)
        out = alpha * prod + beta * c_loc
        gr = me * rows_per + lax.broadcasted_iota(jnp.int32,
                                                  (rows_per, npd), 0)
        gc = lax.broadcasted_iota(jnp.int32, (rows_per, npd), 1)
        keep = gc <= gr if uplo == Uplo.LOWER else gc >= gr
        return jnp.where(keep, out, c_loc).astype(c_loc.dtype)

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(axis, None), P(axis, None)),
                       out_specs=P(axis, None))
    return fn(Xp, Cp)[:n, :n] if npd != n else fn(Xp, Cp)


def herk_dist(uplo, trans, alpha, A, beta, C, mesh: Mesh, axis: str = "d"):
    """Triangle-only C := alpha·op(A)·op(A)ᴴ + beta·C (alpha, beta real),
    C row-sharded; one all_gather supplies the conjugate-transposed
    operand. Real dtypes collapse to syrk_dist.
    (Reference cuMultiGPUCherk/Zherk, include/blas.h:275-287.)"""
    uplo = norm_uplo(uplo)
    if not jnp.issubdtype(A.dtype, jnp.complexfloating):
        tr = "N" if norm_trans(trans) == Trans.NO_TRANS else "T"
        return syrk_dist(uplo, tr, alpha, A, beta, C, mesh, axis)
    X = A if norm_trans(trans) == Trans.NO_TRANS else A.conj().T   # (n, k)
    n = X.shape[0]
    p = mesh.shape[axis]
    npd = _round_up(n, p)
    Xp = _pad_rows(X, npd)
    Cp = C if npd == n else jnp.pad(C, ((0, npd - n), (0, npd - n)))
    rows_per = npd // p

    def body(x_loc, c_loc):
        me = lax.axis_index(axis)
        x_full = lax.all_gather(x_loc, axis).reshape(npd, X.shape[1])
        prod = jnp.matmul(x_loc, x_full.conj().T,
                          precision=config.matmul_precision)
        out = alpha * prod + beta * c_loc
        gr = me * rows_per + lax.broadcasted_iota(jnp.int32,
                                                  (rows_per, npd), 0)
        gc = lax.broadcasted_iota(jnp.int32, (rows_per, npd), 1)
        # herk contract: result diagonal is real (blas.h cherk semantics)
        out = jnp.where(gc == gr, out.real.astype(out.dtype), out)
        keep = gc <= gr if uplo == Uplo.LOWER else gc >= gr
        return jnp.where(keep, out, c_loc).astype(c_loc.dtype)

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(axis, None), P(axis, None)),
                       out_specs=P(axis, None))
    return fn(Xp, Cp)[:n, :n] if npd != n else fn(Xp, Cp)


def trsm_dist(side, uplo, transa, diag, alpha, A, B, mesh: Mesh,
              axis: str = "d"):
    """General distributed triangular solve: X := alpha·inv(op(tri(A)))·B
    (left) or alpha·B·inv(op(tri(A))) (right), any uplo/trans/diag, general
    B (reference cuMultiGPUStrsm family, include/blas.h:338-362).

    Decomposition: a left solve couples every ROW of B but its columns are
    independent — so B is COLUMN-sharded and each device solves its stripe
    locally against the replicated triangle (and vice versa for the right
    side). Zero collectives; the per-stripe solve reuses the single-chip
    blocked driver, so each stripe gets the same fast tiles as the
    single-device tier (the reference likewise reuses its GPU kernels
    inside each multi-GPU task)."""
    from cholesky_tpu.ops import blocked
    side = norm_side(side)
    if side == Side.LEFT:
        n = B.shape[1]
        p = mesh.shape[axis]
        npd = _round_up(n, p)
        Bp = B if npd == n else jnp.pad(B, ((0, 0), (0, npd - n)))

        def body(a_full, b_loc):
            return blocked.trsm(Side.LEFT, uplo, transa, diag, alpha,
                                a_full, b_loc).astype(B.dtype)

        # collective-free body. A rides in as an explicit replicated
        # input — a closure-captured array can carry a sharding that
        # conflicts with the Manual mesh context.
        fn = jax.shard_map(body, mesh=mesh,
                           in_specs=(P(None, None), P(None, axis)),
                           out_specs=P(None, axis))
        out = fn(A, Bp)
        return out[:, :n] if npd != n else out
    m = B.shape[0]
    p = mesh.shape[axis]
    mpd = _round_up(m, p)
    Bp = _pad_rows(B, mpd)

    def body(a_full, b_loc):
        return blocked.trsm(Side.RIGHT, uplo, transa, diag, alpha,
                            a_full, b_loc).astype(B.dtype)

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(None, None), P(axis, None)),
                       out_specs=P(axis, None))
    return fn(A, Bp)[:m]


def trmm_dist(side, uplo, transa, diag, alpha, A, B, mesh: Mesh,
              axis: str = "d"):
    """B := alpha·op(tri(A))·B (left) or alpha·B·op(tri(A)) (right).

    Same decomposition as :func:`trsm_dist`: a left multiply couples the ROWS of B but its columns are
    independent — so B is COLUMN-sharded, the triangle replicated, and
    each device multiplies its stripe through the single-chip
    ``blocked.trmm`` driver, which multiplies only the live triangle
    blocks. Zero collectives (reference bar: dtrmm.cu's structure-aware
    kernels inside each multi-GPU task)."""
    from cholesky_tpu.ops import blocked
    side = norm_side(side)
    p = mesh.shape[axis]
    if side == Side.LEFT:
        n = B.shape[1]
        npd = _round_up(n, p)
        Bp = B if npd == n else jnp.pad(B, ((0, 0), (0, npd - n)))

        def body(a_full, b_loc):
            return blocked.trmm(Side.LEFT, uplo, transa, diag, alpha,
                                a_full, b_loc).astype(B.dtype)

        fn = jax.shard_map(body, mesh=mesh,
                           in_specs=(P(None, None), P(None, axis)),
                           out_specs=P(None, axis))
        out = fn(A, Bp)
        return out[:, :n] if npd != n else out
    # right side: rows of B independent ⇒ row-shard B
    m = B.shape[0]
    mp = _round_up(m, p)
    Bp = _pad_rows(B, mp)

    def body(a_full, b_loc):
        return blocked.trmm(Side.RIGHT, uplo, transa, diag, alpha,
                            a_full, b_loc).astype(B.dtype)

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(None, None), P(axis, None)),
                       out_specs=P(axis, None))
    return fn(A, Bp)[:m]
