"""Reference (oracle) Level-3 BLAS tier — pure jnp, all four precisions.

This is the rebuild's analog of the reference's CPU tier (reference
blas/sgemm.c:34-146, ssyrk.c:34, strmm.c, strsm.c — OpenMP loops over output
columns): a single dtype-generic source instead of four sed-generated copies
(reference single2double.sh / complex2doublecomplex.sh).

Semantics notes vs the reference:
- JAX is functional, so every routine *returns* the updated matrix; the
  reference's in-place/out-of-place split (e.g. ``strmm`` vs ``strmm2``,
  reference include/blas.h:89-129) collapses — ``trmm`` returns the product
  and ``trmm2`` is an alias kept for API parity.
- ``syrk``/``herk`` write only the requested triangle and preserve the other
  triangle of C, exactly like the reference (blas/ssyrk.c triangle-only
  stores).
- All matrices are 2-D jnp arrays; there is no ``lda`` (XLA owns layout).

These implementations are deliberately simple and obviously correct — they
are the oracle that the blocked tier is tested against, the same role as the
reference's ``test/blas/ref/*_ref.c`` naive loops (compiled -O0 there).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from cholesky_tpu import config

from cholesky_tpu.types import (
    Diag, Side, Trans, Uplo,
    norm_diag, norm_side, norm_trans, norm_uplo, is_complex,
)
from cholesky_tpu.utils.errors import check


def op(A, trans):
    """Apply op(A) = A, Aᵀ, or Aᴴ."""
    trans = norm_trans(trans)
    if trans == Trans.NO_TRANS:
        return A
    if trans == Trans.TRANS:
        return A.T
    return A.conj().T


def _tri(A, uplo, diag=Diag.NON_UNIT):
    """Extract the uplo triangle of A (unit diagonal if diag='U'),
    zeroing the rest — the 'referenced part' of a triangular operand."""
    uplo = norm_uplo(uplo)
    diag = norm_diag(diag)
    T = jnp.tril(A) if uplo == Uplo.LOWER else jnp.triu(A)
    if diag == Diag.UNIT:
        n = A.shape[0]
        eye = jnp.eye(n, dtype=A.dtype)
        T = T - jnp.diag(jnp.diag(T)) + eye
    return T


def _set_triangle(C, T, uplo):
    """Write T into the uplo triangle of C, keeping C's other strict
    triangle unchanged."""
    uplo = norm_uplo(uplo)
    if uplo == Uplo.LOWER:
        return jnp.tril(T) + jnp.triu(C, 1)
    return jnp.triu(T) + jnp.tril(C, -1)


# ---------------------------------------------------------------------------
# GEMM — C := alpha*op(A)*op(B) + beta*C           (reference blas/sgemm.c:34)
# ---------------------------------------------------------------------------

def gemm(transa, transb, alpha, A, B, beta, C):
    oA, oB = op(A, transa), op(B, transb)
    m, k = oA.shape
    kb, n = oB.shape
    check(k == kb, "gemm", 5, f"inner dims {k} != {kb}")
    check(C.shape == (m, n), "gemm", 7, f"C shape {C.shape} != {(m, n)}")
    prod = jnp.matmul(oA, oB, preferred_element_type=C.dtype, precision=config.matmul_precision)
    return (alpha * prod + beta * C).astype(C.dtype)


def gemm2(transa, transb, alpha, A, B, beta, C):
    """Out-of-place GEMM (reference cuXgemm2, include/blas.h:180-190).
    Functionally identical to :func:`gemm` in JAX."""
    return gemm(transa, transb, alpha, A, B, beta, C)


# ---------------------------------------------------------------------------
# SYRK — C := alpha*A*Aᵀ + beta*C (triangle only)  (reference blas/ssyrk.c:34)
# HERK — C := alpha*A*Aᴴ + beta*C, alpha/beta real (reference blas/cherk.c)
# ---------------------------------------------------------------------------

def syrk(uplo, trans, alpha, A, beta, C):
    trans = norm_trans(trans)
    check(trans != Trans.CONJ_TRANS or not is_complex(A.dtype),
          "syrk", 2, "syrk with 'C' on complex operands — use herk")
    oA = op(A, trans)
    n = oA.shape[0]
    check(C.shape == (n, n), "syrk", 6, f"C shape {C.shape} != {(n, n)}")
    prod = jnp.matmul(oA, oA.T, preferred_element_type=C.dtype, precision=config.matmul_precision)
    return _set_triangle(C, alpha * prod + beta * C, uplo).astype(C.dtype)


def herk(uplo, trans, alpha, A, beta, C):
    """alpha and beta are real; the result's diagonal imaginary part is
    exactly zero (reference include/blas.h:57-66)."""
    trans = norm_trans(trans)
    check(trans != Trans.TRANS or not is_complex(A.dtype),
          "herk", 2, "herk with 'T' on complex operands — use syrk")
    oA = op(A, trans)
    n = oA.shape[0]
    check(C.shape == (n, n), "herk", 6, f"C shape {C.shape} != {(n, n)}")
    prod = jnp.matmul(oA, oA.conj().T, preferred_element_type=C.dtype,
                      precision=config.matmul_precision)
    out = alpha * prod + beta * C
    if is_complex(C.dtype):
        dimag = jnp.diag(jnp.diag(out).imag)
        out = out - lax.complex(jnp.zeros_like(dimag), dimag).astype(C.dtype)
    return _set_triangle(C, out, uplo).astype(C.dtype)


# ---------------------------------------------------------------------------
# TRMM — B := alpha*op(A)*B (left) or alpha*B*op(A) (right)
#                                                   (reference blas/strmm.c)
# ---------------------------------------------------------------------------

def trmm(side, uplo, transa, diag, alpha, A, B):
    side = norm_side(side)
    T = op(_tri(A, uplo, diag), transa)
    if side == Side.LEFT:
        check(A.shape[0] == B.shape[0], "trmm", 6, "dim mismatch")
        out = jnp.matmul(T, B, preferred_element_type=B.dtype, precision=config.matmul_precision)
    else:
        check(A.shape[0] == B.shape[1], "trmm", 6, "dim mismatch")
        out = jnp.matmul(B, T, preferred_element_type=B.dtype, precision=config.matmul_precision)
    return (alpha * out).astype(B.dtype)


def trmm2(side, uplo, transa, diag, alpha, A, B):
    """Out-of-place TRMM (reference cuXtrmm2, include/blas.h:213-232)."""
    return trmm(side, uplo, transa, diag, alpha, A, B)


# ---------------------------------------------------------------------------
# TRSM — B := alpha*inv(op(A))*B (left) or alpha*B*inv(op(A)) (right)
#                                                   (reference blas/strsm.c)
# ---------------------------------------------------------------------------

def trsm(side, uplo, transa, diag, alpha, A, B):
    side = norm_side(side)
    uplo = norm_uplo(uplo)
    transa = norm_trans(transa)
    diag = norm_diag(diag)
    unit = diag == Diag.UNIT

    # Reduce the right-side case to a left-side solve on transposes:
    #   X * op(A) = alpha*B  <=>  op(A)ᵀ * Xᵀ = alpha*Bᵀ
    if side == Side.RIGHT:
        if transa == Trans.CONJ_TRANS:
            # (Aᴴ)ᵀ = conj(A): solve conj(A) Xᵀ = alpha Bᵀ
            #  <=> A conj(Xᵀ) = conj(alpha) conj(Bᵀ)
            out = trsm(Side.LEFT, uplo, Trans.NO_TRANS, diag,
                       jnp.conj(alpha), A, B.conj().T)
            return out.conj().T
        eff_trans = Trans.TRANS if transa == Trans.NO_TRANS else Trans.NO_TRANS
        out = trsm(Side.LEFT, uplo, eff_trans, diag, alpha, A, B.T)
        return out.T

    check(A.shape[0] == B.shape[0], "trsm", 6, "dim mismatch")
    T = _tri(A, uplo, diag)
    lower = uplo == Uplo.LOWER
    trans_arg = {Trans.NO_TRANS: 0, Trans.TRANS: 1, Trans.CONJ_TRANS: 2}[transa]
    X = lax.linalg.triangular_solve(
        T, alpha * B.astype(T.dtype),
        left_side=True, lower=lower,
        transpose_a=trans_arg > 0, conjugate_a=trans_arg == 2,
        unit_diagonal=unit)
    return X.astype(B.dtype)
