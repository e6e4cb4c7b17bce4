"""Reference (oracle) LAPACK tier — pure jnp, jittable, all four precisions.

Rebuild of the reference's CPU LAPACK tier (reference lapack/spotrf.c,
strtri.c, slauum.c, spotri.c, slogdet.c) as a single dtype-generic source.

``info`` semantics under jit: a compiled program cannot early-exit, so
every routine computes the full (masked) result and *returns* ``info`` as a
traced int32 — 0 on success, else the 1-based index of the first failing
pivot, exactly the value the reference stores (reference lapack/spotrf.c:47-51,
112-115). Entries "after" a failure are well-defined garbage (clamped to stay
finite) rather than untouched; callers must treat them as the reference does —
meaningless when info != 0.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from cholesky_tpu import config

from cholesky_tpu.types import (
    Diag, Trans, Uplo,
    norm_diag, norm_uplo, is_complex, real_dtype,
)
from cholesky_tpu.utils.errors import check
from cholesky_tpu.ops import blas_ref as blas


def _square(A, name):
    check(A.ndim == 2 and A.shape[0] == A.shape[1], name, 2,
          f"expected square matrix, got {A.shape}")
    return A.shape[0]


# ---------------------------------------------------------------------------
# POTF2 — unblocked Cholesky (reference lapack/spotrf.c:35-82)
# ---------------------------------------------------------------------------

def potf2(uplo, A):
    """Unblocked Cholesky of the uplo triangle. Returns (A_factored, info).

    Lower: A = L·Lᴴ with L in the lower triangle; upper: A = Uᴴ·U with U in
    the upper triangle. The opposite strict triangle is left unchanged, as in
    the reference.
    """
    uplo = norm_uplo(uplo)
    n = _square(A, "potf2")
    if n == 0:
        return A, jnp.int32(0)
    rdt = real_dtype(A.dtype)
    idx = jnp.arange(n)

    def body_lower(j, carry):
        A, info = carry
        # freeze-at-first-failure: once info latched, later columns keep
        # their original values (the reference spotf2 RETURNS at the bad
        # pivot, lapack/spotrf.c:47-51). Continuing with substituted
        # pivots squares magnitudes each column ((col − A·rowm)/d with
        # garbage rows) — doubling-exponent growth that overflowed to
        # ±Inf within ~12 columns of a failure (found by the r5 verify
        # drive at n=256), violating the finite-outputs contract.
        frozen = info > 0
        row = lax.dynamic_slice(A, (j, 0), (1, n))[0]
        maskj = idx < j
        rowm = jnp.where(maskj, row, jnp.zeros((), A.dtype))
        diag_j = jnp.sum(jnp.where(idx == j, row, 0)).real.astype(rdt)
        ajj = diag_j - jnp.sum((rowm * rowm.conj()).real).astype(rdt)
        # NaN-safe: ~(ajj > 0) is True for NaN pivots too (the reference
        # spotf2 checks `aii <= zero || isnan(aii)`, lapack/spotrf.c:47-51)
        bad = ~(ajj > 0)
        info = jnp.where(bad & (info == 0), j + 1, info).astype(jnp.int32)
        d = jnp.sqrt(jnp.where(bad, jnp.ones((), rdt), ajj))
        col = lax.dynamic_slice(A, (0, j), (n, 1))[:, 0]
        # dot products over k < j only, as the reference's sdot does: a
        # non-finite entry in columns ≥ j must not leak in through 0·NaN
        Aj = jnp.where(maskj[None, :], A, jnp.zeros((), A.dtype))
        v = jnp.matmul(Aj, rowm.conj(), precision=config.matmul_precision)
        newcol = (col - v) / d.astype(A.dtype)
        out = jnp.where(idx > j, newcol,
                        jnp.where(idx == j, d.astype(A.dtype), col))
        A = lax.dynamic_update_slice(
            A, jnp.where(frozen, col, out)[:, None], (0, j))
        return A, info

    def body_upper(j, carry):
        A, info = carry
        frozen = info > 0   # freeze-at-first-failure (see body_lower)
        col = lax.dynamic_slice(A, (0, j), (n, 1))[:, 0]
        maskj = idx < j
        colm = jnp.where(maskj, col, jnp.zeros((), A.dtype))
        diag_j = jnp.sum(jnp.where(idx == j, col, 0)).real.astype(rdt)
        ajj = diag_j - jnp.sum((colm * colm.conj()).real).astype(rdt)
        bad = ~(ajj > 0)    # NaN-safe (see body_lower)
        info = jnp.where(bad & (info == 0), j + 1, info).astype(jnp.int32)
        d = jnp.sqrt(jnp.where(bad, jnp.ones((), rdt), ajj))
        row = lax.dynamic_slice(A, (j, 0), (1, n))[0]
        Aj = jnp.where(maskj[:, None], A, jnp.zeros((), A.dtype))
        v = jnp.matmul(colm.conj(), Aj, precision=config.matmul_precision)
        newrow = (row - v) / d.astype(A.dtype)
        out = jnp.where(idx > j, newrow,
                        jnp.where(idx == j, d.astype(A.dtype), row))
        A = lax.dynamic_update_slice(
            A, jnp.where(frozen, row, out)[None, :], (j, 0))
        return A, info

    body = body_lower if uplo == Uplo.LOWER else body_upper
    # initial info derived from A so its varying-axes signature matches the
    # loop output under shard_map (see parallel/potrf.py)
    info0 = (jnp.sum(A.real) * 0).astype(jnp.int32)
    A, info = lax.fori_loop(0, n, body, (A, info0))
    return A, info


# ---------------------------------------------------------------------------
# POTRF — blocked Cholesky (reference lapack/spotrf.c:84-147; nb=16/32 there)
# ---------------------------------------------------------------------------

def potrf(uplo, A, block_size: int = 64):
    """Blocked Cholesky: syrk/herk → potf2 → gemm → trsm per block column,
    the same left-looking schedule as the reference CPU tier."""
    uplo = norm_uplo(uplo)
    n = _square(A, "potrf")
    nb = block_size
    if n == 0:
        return A, jnp.int32(0)
    if n <= nb:
        return potf2(uplo, A)

    cplx = is_complex(A.dtype)
    rk = (lambda ul, tr, a, X, b, C: blas.herk(ul, tr, a, X, b, C)) if cplx \
        else (lambda ul, tr, a, X, b, C: blas.syrk(ul, tr, a, X, b, C))
    tc = Trans.CONJ_TRANS if cplx else Trans.TRANS

    info = jnp.int32(0)
    for j in range(0, n, nb):
        jb = min(nb, n - j)
        if uplo == Uplo.LOWER:
            # diag update: A[j:j+jb, j:j+jb] -= A[j:, :j] A[j:, :j]ᴴ
            Ajj = A[j:j + jb, j:j + jb]
            Ajl = A[j:j + jb, :j]
            Ajj = rk(uplo, Trans.NO_TRANS, -1.0, Ajl, 1.0, Ajj)
            Ajj, linfo = potf2(uplo, Ajj)
            A = A.at[j:j + jb, j:j + jb].set(Ajj)
            if j + jb < n:
                Apl = A[j + jb:, :j]
                Apj = A[j + jb:, j:j + jb]
                Apj = blas.gemm(Trans.NO_TRANS, tc, -1.0, Apl, Ajl, 1.0, Apj)
                Apj = blas.trsm("R", uplo, tc, Diag.NON_UNIT, 1.0, Ajj, Apj)
                A = A.at[j + jb:, j:j + jb].set(Apj)
        else:
            Ajj = A[j:j + jb, j:j + jb]
            Auj = A[:j, j:j + jb]
            Ajj = rk(uplo, tc, -1.0, Auj, 1.0, Ajj)
            Ajj, linfo = potf2(uplo, Ajj)
            A = A.at[j:j + jb, j:j + jb].set(Ajj)
            if j + jb < n:
                Aup = A[:j, j + jb:]
                Ajp = A[j:j + jb, j + jb:]
                Ajp = blas.gemm(tc, Trans.NO_TRANS, -1.0, Auj, Aup, 1.0, Ajp)
                Ajp = blas.trsm("L", uplo, tc, Diag.NON_UNIT, 1.0, Ajj, Ajp)
                A = A.at[j:j + jb, j + jb:].set(Ajp)
        # propagate first failure with block offset (reference spotrf.c:112-115)
        info = jnp.where((info == 0) & (linfo > 0), linfo + j, info)
    return A, info.astype(jnp.int32)


# ---------------------------------------------------------------------------
# TRTI2 / TRTRI — triangular inverse (reference lapack/strtri.c:43-164)
# ---------------------------------------------------------------------------

def trti2(uplo, diag, A):
    """Unblocked in-place triangular inverse. Returns (A_inv, info)."""
    uplo = norm_uplo(uplo)
    diag = norm_diag(diag)
    n = _square(A, "trti2")
    if n == 0:
        return A, jnp.int32(0)
    unit = diag == Diag.UNIT
    idx = jnp.arange(n)
    one = jnp.ones((), A.dtype)

    def diag_of(col, j):
        return jnp.sum(jnp.where(idx == j, col, 0))

    def body_upper(j, carry):
        A, info = carry
        col = lax.dynamic_slice(A, (0, j), (n, 1))[:, 0]
        ajj_old = diag_of(col, j)
        if unit:
            ajj = one
        else:
            bad = ajj_old == 0
            info = jnp.where(bad & (info == 0), j + 1, info).astype(jnp.int32)
            ajj = one / jnp.where(bad, one, ajj_old)
        colm = jnp.where(idx < j, col, jnp.zeros((), A.dtype))
        U = jnp.triu(A, 1) if unit else jnp.triu(A)
        if unit:
            v = jnp.matmul(U, colm, precision=config.matmul_precision) + colm  # unit diag contributes x
        else:
            v = jnp.matmul(U, colm, precision=config.matmul_precision)
        newcol = -ajj * v
        out = jnp.where(idx < j, newcol,
                        jnp.where(idx == j,
                                  ajj if not unit else jnp.sum(
                                      jnp.where(idx == j, col, 0)),
                                  col))
        A = lax.dynamic_update_slice(A, out[:, None], (0, j))
        return A, info

    def body_lower(i, carry):
        A, info = carry
        j = n - 1 - i
        col = lax.dynamic_slice(A, (0, j), (n, 1))[:, 0]
        ajj_old = diag_of(col, j)
        if unit:
            ajj = one
        else:
            bad = ajj_old == 0
            info = jnp.where(bad & (info == 0), j + 1, info).astype(jnp.int32)
            ajj = one / jnp.where(bad, one, ajj_old)
        colm = jnp.where(idx > j, col, jnp.zeros((), A.dtype))
        L = jnp.tril(A, -1) if unit else jnp.tril(A)
        if unit:
            v = jnp.matmul(L, colm, precision=config.matmul_precision) + colm
        else:
            v = jnp.matmul(L, colm, precision=config.matmul_precision)
        newcol = -ajj * v
        out = jnp.where(idx > j, newcol,
                        jnp.where(idx == j,
                                  ajj if not unit else jnp.sum(
                                      jnp.where(idx == j, col, 0)),
                                  col))
        A = lax.dynamic_update_slice(A, out[:, None], (0, j))
        return A, info

    body = body_upper if uplo == Uplo.UPPER else body_lower
    info0 = (jnp.sum(A.real) * 0).astype(jnp.int32)
    A, info = lax.fori_loop(0, n, body, (A, info0))
    return A, info


def trtri(uplo, diag, A):
    """Triangular inverse (reference strtri.c:43-164). The reference blocks
    this over trmm/trsm; the oracle tier uses the unblocked sweep directly
    (the blocked fast path lives in ops/blocked.py)."""
    return trti2(uplo, diag, A)


def trtri2(uplo, diag, A):
    """Out-of-place triangular inverse (reference strtri2, strtri.c:166-299).
    In functional JAX this is the same computation; kept for API parity."""
    return trti2(uplo, diag, A)


# ---------------------------------------------------------------------------
# LAUU2 / LAUUM — triangular square (reference lapack/slauum.c:43-129)
# ---------------------------------------------------------------------------

def lauu2(uplo, A):
    """A := U·Uᴴ (upper) or Lᴴ·L (lower), result stored in the same
    triangle; opposite strict triangle unchanged (LAPACK xlauu2 semantics)."""
    uplo = norm_uplo(uplo)
    _square(A, "lauu2")
    if uplo == Uplo.UPPER:
        U = jnp.triu(A)
        prod = jnp.matmul(U, U.conj().T, preferred_element_type=A.dtype,
                          precision=config.matmul_precision)
    else:
        L = jnp.tril(A)
        prod = jnp.matmul(L.conj().T, L, preferred_element_type=A.dtype,
                          precision=config.matmul_precision)
    if is_complex(A.dtype):
        dimag = jnp.diag(jnp.diag(prod).imag)
        prod = prod - lax.complex(jnp.zeros_like(dimag), dimag).astype(A.dtype)
    return blas._set_triangle(A, prod, uplo).astype(A.dtype)


def lauum(uplo, A):
    """Blocked version collapses to the same computation at this tier."""
    return lauu2(uplo, A)


# ---------------------------------------------------------------------------
# POTRI — SPD/HPD inverse from the Cholesky factor
#                                          (reference lapack/spotri.c:4-23)
# ---------------------------------------------------------------------------

def potri(uplo, A):
    """A contains the Cholesky factor (from potrf); returns (A_inv, info),
    the inverse stored in the uplo triangle. Pure composition trtri→lauum,
    exactly like the reference at every tier (spotri.c)."""
    W, info = trtri(uplo, Diag.NON_UNIT, A)
    return lauum(uplo, W), info


# ---------------------------------------------------------------------------
# LOGDET (reference lapack/slogdet.c:10-25, slogdet.cu reduction)
# ---------------------------------------------------------------------------

def logdet_from_factor(x):
    """2·Σ log(re(xᵢ)) over the Cholesky diagonal.

    The reference's CPU slogdet takes a strided vector — the diagonal of the
    factored matrix (incx = lda+1, reference slogdet.c:10-25); here pass
    either the factored matrix (its diagonal is used) or a 1-D diagonal.
    Complex variants use log(creal(x)) like the reference (clogdet.c:11-26).
    XLA's tree reduction keeps the summation error at the O(log n · eps)
    pairwise level, which fixes the reference's known large-n logdet
    tolerance FAILs (BASELINE.md honesty notes).
    """
    d = jnp.diagonal(x) if x.ndim == 2 else x
    rdt = real_dtype(d.dtype)
    return 2.0 * jnp.sum(jnp.log(d.real.astype(rdt)))


def logdet(uplo, A, block_size: int = 64):
    """Fused SPD log-determinant: potrf + log-diagonal reduction.
    Returns (value, info)."""
    F, info = potrf(uplo, A, block_size=block_size)
    return logdet_from_factor(F), info
