"""Blocked single-device drivers: recursive POTRF/TRTRI/LAUUM/POTRI/TRSM/TRMM.

This is the analog of the reference's cu* single-GPU hybrid tier
(reference lapack/spotrf.c:261-398, strtri.c:369-472, slauum.c:197-305),
re-designed for XLA's compilation model:

- The reference's *iterative* block-column loop with stream overlap becomes
  *recursive* halving: every level splits the matrix in two, so the trailing
  updates are the largest possible GEMM/SYRK calls (XLA hands them to
  cuBLAS) and only O(log n) distinct shapes are compiled. Overlap is XLA's
  job (it schedules independent ops inside one compiled program), not
  hand-managed streams.
- The reference's diagonal-block trick with the *inverse* substitution
  (factor the diagonal block, invert it, replace the panel TRSM by a TRMM —
  reference hybridSpotrf spotrf.c:207-259, the thesis contribution) is kept
  at the leaves: the diagonal block is factored and inverted ON THE DEVICE
  (cuSOLVER potrf + cuBLAS trsm), and the TRSM recursion bottoms out in a
  GEMM by that inverse, which turns all solves into matmuls.
- Matrices are padded to a block-size multiple with an identity diagonal
  block (exact for potrf/trtri/lauum/trsm/trmm), replacing the reference's
  runtime cleanup-tile logic.

Tile backends:
  'xla'     XLA matmuls at ``config.matmul_precision`` + library-solver
            leaves (_XlaTiles); every dtype.
  'ozaki'   f64 matmuls as exact int8-slice products (ops/ozaki.py).
  'auto'    'xla' for every dtype.

Upper-triangle cases are canonicalized to lower via conjugate transposition
(valid because only the selected triangle of the input is referenced), and
the opposite strict triangle of the caller's matrix is restored on return,
matching the reference's storage semantics.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from jax import lax

from cholesky_tpu import config
from cholesky_tpu.types import (
    Diag, Side, Trans, Uplo,
    norm_diag, norm_side, norm_trans, norm_uplo, is_complex,
)
from cholesky_tpu.utils.errors import check
from cholesky_tpu.ops import blas_ref, lapack_ref
from cholesky_tpu.ops.dispatch import _resolve


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Tile backends
# ---------------------------------------------------------------------------

def _zero_info(A):
    """int32 zero carrying A's varying mesh axes, so both branches of a
    leaf's rescue ``lax.cond`` agree under ``shard_map``'s vma checker.
    (XLA converts a NaN to 0, and the callers only take this branch when
    the leaf result is finite anyway.)"""
    return (A[0, 0].real * 0).astype(jnp.int32)


class _XlaTiles:
    """Generic-dtype tiles over XLA: matmuls at ``config.matmul_precision``
    (cuBLAS on the GPU; HIGHEST keeps f32 out of TF32), and nb×nb leaves
    through the device's dense solvers — ``lax.linalg.cholesky`` (cuSOLVER
    potrf) and ``lax.linalg.triangular_solve`` (cuBLAS trsm), the on-device
    form of the reference's host-LAPACK diagonal block.

    cuSOLVER reports a failed factorization only as non-finite output, so
    the potf2 leaf re-runs the oracle column sweep (lapack_ref) under
    ``lax.cond`` when its result is not finite: that branch supplies the
    1-based ``info`` and the freeze-at-first-failure output, and runs only
    for a failing leaf. The trti2 leaf needs no such branch: its ``info``
    is the first zero pivot, read off the diagonal.

    default_nb = 256: inside a full potrf at n=16384 on an H100 it beat
    nb=128 in run time and compile time (PERF.md)."""
    default_nb = 256

    def __init__(self, dtype):
        self.dtype = jnp.dtype(dtype)

    def _op(self, X, t):
        if t == "N":
            return X
        if t == "T":
            return X.T
        return X.conj().T

    def mm(self, A, B, *, ta="N", tb="N", alpha=1.0, beta=0.0, C=None):
        out = jnp.matmul(self._op(A, ta), self._op(B, tb),
                         preferred_element_type=self.dtype,
                         precision=config.matmul_precision)
        out = alpha * out
        if C is not None and beta != 0.0:
            out = out + beta * C
        return out.astype(self.dtype)

    def syrk_ln(self, alpha, A, beta, C):
        # full symmetric product; only the lower triangle is contractually
        # valid (XLA cannot exploit the symmetry)
        conj = A.conj() if is_complex(self.dtype) else A
        return self.mm(A, conj, tb="T", alpha=alpha, beta=beta, C=C)

    def potf2(self, A):
        # symmetrize_input=False: only the lower triangle may be read
        L = jnp.tril(lax.linalg.cholesky(A, symmetrize_input=False))

        def sweep(_):
            F, info = lapack_ref.potf2(Uplo.LOWER, A)
            return jnp.tril(F), info

        return lax.cond(jnp.all(jnp.isfinite(L)),
                        lambda _: (L, _zero_info(A)), sweep, None)

    def trti2(self, A, *, unit=False):
        n = A.shape[0]
        d = jnp.diag(A)
        if unit:
            info = _zero_info(A)
        else:
            # info = first exactly-zero pivot (1-based), as lapack_ref.trti2
            # reports it; like that sweep, invert with 1 in its place so the
            # output stays finite
            zero = d == 0
            info = jnp.where(jnp.any(zero), jnp.argmax(zero) + 1,
                             _zero_info(A)).astype(jnp.int32)
            A = A + jnp.diag(jnp.where(zero, 1, 0).astype(A.dtype))
        W = lax.linalg.triangular_solve(A, jnp.eye(n, dtype=A.dtype),
                                        left_side=True, lower=True,
                                        unit_diagonal=unit)
        if unit:
            # LAPACK contract: unit diagonal entries pass through untouched
            return jnp.tril(W, -1) + jnp.diag(d), info
        return jnp.tril(W), info

    def lauu2(self, A):
        # strict upper of the result is zero: only the lower is read
        return lapack_ref.lauu2(Uplo.LOWER, jnp.tril(A))

class _OzakiTiles(_XlaTiles):
    """f64 tiles whose matmuls are exact int8-slice products (the Ozaki
    scheme, ops/ozaki.py) — the explicit ``backend='ozaki'``.

    Leaves are refined from f32: the diagonal block is factored/inverted
    by the f32 leaf and promoted with ONE correction step built from
    Ozaki matmuls, squaring the f32 error (~2^-24 → ~2^-48):
      potf2:  L = Lₕ + Lₕ·Φ(Lₕ⁻¹ R Lₕ⁻ᵀ),  R = A − LₕLₕᵀ,
              Φ = strict-lower + ½·diag  (the standard Cholesky
              differential/refinement identity)
      trti2:  one Newton step  W₁ = W₀(2I − L·W₀)
    slices=6 gives ~2^-42 products, far inside the ≤1e-6 backward-error
    target (BASELINE.md). The recursions (trsm_*, trtri_lower, trmm_lln,
    syrk_ln) peel the factor ONCE and index that shared int8
    representation from every block update.
    """
    default_nb = 128
    slices = 6

    def __init__(self, slices: int = 6):
        super().__init__(jnp.float64)
        self.slices = slices

    def mm(self, A, B, *, ta="N", tb="N", alpha=1.0, beta=0.0, C=None):
        from cholesky_tpu.ops.ozaki import matmul_f64
        A = self._op(A, ta)
        B = self._op(B, tb)
        out = alpha * matmul_f64(A, B, slices=self.slices)
        if C is not None and beta != 0.0:
            out = out + beta * C
        return out

    def potf2(self, A):
        from cholesky_tpu.ops.ozaki import matmul_f64
        A32 = A.astype(jnp.float32)
        Lh32, info = _XlaTiles(jnp.float32).potf2(A32)
        # past a frozen failure the leaf leaves raw (<=0, possibly ~0)
        # input values on the diagonal; sanitize before the refinement
        # solves so 1/0 cannot poison the output (break semantics: the
        # leading info-1 block is exact either way — a lower-triangular
        # solve's leading entries never touch the garbage rows below)
        d32 = jnp.diag(Lh32)
        Lh32 = Lh32 - jnp.diag(d32) + jnp.diag(jnp.where(d32 > 0, d32, 1.0))
        Lh = Lh32.astype(A.dtype)
        # R must be the full SYMMETRIC residual (G = Lₕ⁻¹RLₕ⁻ᵀ uses both
        # triangles); only the lower triangle of A is valid storage
        Afull = jnp.tril(A) + jnp.tril(A, -1).T
        R = Afull - matmul_f64(Lh, Lh.T, slices=self.slices)
        # G = Lₕ⁻¹ R Lₕ⁻ᵀ in f32 (R is already O(2^-24·‖A‖); first order)
        R32 = R.astype(jnp.float32)
        G32 = lax.linalg.triangular_solve(Lh32, R32, left_side=True,
                                          lower=True)
        G32 = lax.linalg.triangular_solve(Lh32, G32.T, left_side=True,
                                          lower=True).T
        Phi = jnp.tril(G32, -1) + 0.5 * jnp.diag(jnp.diag(G32))
        E = jnp.matmul(Lh32, Phi, precision=config.matmul_precision)
        refined = jnp.tril(Lh + E.astype(A.dtype))

        # f64 rescue: the f32 leaf decides failure at f32 precision, so a
        # matrix PD in f64 but borderline at f32 (leading minors within
        # ~2⁻²⁴ of zero) would wrongly report info > 0 — a semantic
        # divergence from reference dpotrf (reference lapack/dpotrf.c potf2
        # pivots in full f64).  When the f32 leaf flags a failure, re-factor
        # this leaf with the true-f64 reference potf2; lax.cond executes
        # that branch ONLY on flagged leaves.  Final info is therefore
        # always an f64 verdict.  (The mirror case — f32 accepting a pivot
        # that is ≤0 in exact f64 arithmetic — remains precision-limited,
        # as in any fixed-precision dpotrf.)
        def _rescue(_):
            L64, info64 = lapack_ref.potf2("L", A)
            return jnp.tril(L64), info64

        return lax.cond(info > 0, _rescue,
                        lambda _: (refined, info), operand=None)

    def trti2(self, A, *, unit=False):
        from cholesky_tpu.ops.ozaki import matmul_f64
        n = A.shape[0]
        A32 = A.astype(jnp.float32)
        W32, info = _XlaTiles(jnp.float32).trti2(A32, unit=unit)
        if unit:
            W32 = jnp.tril(W32, -1) + jnp.eye(n, dtype=jnp.float32)
        W0 = W32.astype(A.dtype)
        L = jnp.tril(A, -1) + (jnp.eye(n, dtype=A.dtype) if unit
                               else jnp.diag(jnp.diag(A)))
        # Newton: W₁ = W₀(2I − L·W₀) — squares the f32 inversion error
        T = matmul_f64(L, W0, slices=self.slices)
        D = 2.0 * jnp.eye(n, dtype=A.dtype) - T
        W1 = jnp.tril(matmul_f64(W0, D, slices=self.slices))
        if unit:
            # LAPACK contract: unit diagonal entries pass through untouched
            W1 = jnp.tril(W1, -1) + jnp.diag(jnp.diag(A))
        return W1, info

    def lauu2(self, A):
        from cholesky_tpu.ops.ozaki import matmul_f64
        L = jnp.tril(A)
        P = matmul_f64(L.T, L, slices=self.slices)
        return jnp.tril(P) + jnp.triu(A, 1)

    def syrk_ln(self, alpha, A, beta, C):
        """C = α·A·Aᵀ (+ β·C) with ONE peel serving both sides: the
        B-side representation of A·Aᵀ (= split_rows((Aᵀ)ᵀ)) is exactly
        the A-side one, so the generic ``mm`` path's second peel is pure
        waste. Halves the peel traffic of every trailing update in the d
        potrf/lauum recursions (reference dsyrk.cu's single-operand
        tiling, SURVEY.md §2.2)."""
        from cholesky_tpu.ops.ozaki import matmul_presplit, split_rows
        As, asc = split_rows(A, self.slices)
        out = matmul_presplit(As, asc, As, asc, out_dtype=self.dtype)
        if alpha != 1.0:
            out = alpha * out
        if C is not None and beta != 0.0:
            out = out + (beta * C if beta != 1.0 else C)
        return out

    def trsm_rlt(self, L, B, nb):
        """X·Lᵀ = B (the potrf panel solve) with L's peel hoisted across
        all recursion levels (the trmm_lln pattern applied to the solve):
        the factor-side operand of every
        off-diagonal update indexes ONE shared int8 representation
        instead of re-peeling per call. Row scales come from the full
        tril'd rows — restriction of a peel to a sub-block stays exact
        (ozaki.split_rows), only the dropped-pair bound loosens from
        blockmax to rowmax (irrelevant at slices=6 ≈ 2⁻⁴²)."""
        from cholesky_tpu.ops.ozaki import matmul_presplit, split_rows
        Lt = jnp.tril(L)    # a garbage strict-upper would poison the
        Ls, lsc = split_rows(Lt, self.slices)      # shared row scales

        def rec(i, n, B):
            if n <= nb:
                T, _ = self.trti2(Lt[i:i + n, i:i + n])
                return self.mm(B, T, tb="C")
            n1 = _split(n, nb)
            X1 = rec(i, n1, B[:, :n1])
            Xs, xsc = split_rows(X1, self.slices)
            upd = matmul_presplit(Xs, xsc,
                                  Ls[:, i + n1:i + n, i:i + n1],
                                  lsc[i + n1:i + n], out_dtype=self.dtype)
            X2 = rec(i + n1, n - n1, B[:, n1:] - upd)
            return jnp.concatenate([X1, X2], axis=1)

        return rec(0, L.shape[0], B)

    def trsm_lln(self, L, B, nb, unit):
        """L·X = B, forward sweep, L's peel hoisted (see trsm_rlt)."""
        from cholesky_tpu.ops.ozaki import matmul_presplit, split_rows
        Lt = jnp.tril(L)
        Ls, lsc = split_rows(Lt, self.slices)

        def rec(i, n, B):
            if n <= nb:
                T, _ = self.trti2(Lt[i:i + n, i:i + n], unit=unit)
                if unit:
                    T = _force_unit_diag(T)
                return self.mm(T, B)
            n1 = _split(n, nb)
            X1 = rec(i, n1, B[:n1])
            Xs, xsc = split_rows(X1.T, self.slices)
            upd = matmul_presplit(Ls[:, i + n1:i + n, i:i + n1],
                                  lsc[i + n1:i + n], Xs, xsc,
                                  out_dtype=self.dtype)
            X2 = rec(i + n1, n - n1, B[n1:] - upd)
            return jnp.concatenate([X1, X2], axis=0)

        return rec(0, L.shape[0], B)

    def trsm_llt(self, L, B, nb, unit):
        """Lᵀ·X = B, backward sweep; the hoisted representation is the
        peel of Lᵀ (the A-side of every update is Mᵀ, a column slab)."""
        from cholesky_tpu.ops.ozaki import matmul_presplit, split_rows
        Lt = jnp.tril(L)
        LTs, ltsc = split_rows(Lt.T, self.slices)

        def rec(i, n, B):
            if n <= nb:
                T, _ = self.trti2(Lt[i:i + n, i:i + n], unit=unit)
                if unit:
                    T = _force_unit_diag(T)
                return self.mm(T, B, ta="T")
            n1 = _split(n, nb)
            X2 = rec(i + n1, n - n1, B[n1:])
            Xs, xsc = split_rows(X2.T, self.slices)
            upd = matmul_presplit(LTs[:, i:i + n1, i + n1:i + n],
                                  ltsc[i:i + n1], Xs, xsc,
                                  out_dtype=self.dtype)
            X1 = rec(i, n1, B[:n1] - upd)
            return jnp.concatenate([X1, X2], axis=0)

        return rec(0, L.shape[0], B)

    def trtri_lower(self, L, nb, unit):
        """Blocked lower triangular inverse with the factor-side peel of
        every column update hoisted: M' = −W₂·M·W₁ reads M = L[2,1]
        through one shared peel of Lᵀ (reference strtri.c:369-472
        column-update scheme)."""
        from cholesky_tpu.ops.ozaki import matmul_presplit, split_rows
        Lt = jnp.tril(L)
        LTs, ltsc = split_rows(Lt.T, self.slices)

        def rec(i, n):
            if n <= nb:
                return self.trti2(Lt[i:i + n, i:i + n], unit=unit)
            n1 = _split(n, nb)
            W1, i1 = rec(i, n1)
            W2, i2 = rec(i + n1, n - n1)
            W1e = _force_unit_diag(W1) if unit else W1
            W2e = _force_unit_diag(W2) if unit else W2
            Ws, wsc = split_rows(W2e, self.slices)
            P = matmul_presplit(Ws, wsc, LTs[:, i:i + n1, i + n1:i + n],
                                ltsc[i:i + n1], out_dtype=self.dtype)
            Mp = self.mm(P, W1e, alpha=-1.0)
            n2 = n - n1
            top = jnp.concatenate([W1, jnp.zeros((n1, n2), L.dtype)],
                                  axis=1)
            bot = jnp.concatenate([Mp, W2], axis=1)
            info = jnp.where(i1 > 0, i1,
                             jnp.where(i2 > 0, i2 + n1, 0)).astype(jnp.int32)
            return jnp.concatenate([top, bot], axis=0), info

        return rec(0, L.shape[0])

    def trmm_lln(self, L, B, nb):
        """Live-block L·B (L exactly lower-triangular) with the int8 slice
        peel HOISTED: both operands are peeled ONCE and every block matmul
        indexes the shared representation instead of re-peeling per
        block. The f64 answer to the reference's triangle-aware dtrmm
        (blas/dtrmm.cu:1-1744): only live blocks are multiplied."""
        from cholesky_tpu.ops.ozaki import matmul_presplit, split_rows
        Ls, lsc = split_rows(L, self.slices)             # (S, n, n), (n,)
        Bs, bsc = split_rows(B.T, self.slices)           # (S, p, n), (p,)

        def rec(i, n):
            # absorb ragged tails up to 1.5*nb into one leaf: splitting
            # 1.5*nb into (nb, nb/2) costs an extra presplit call and a
            # half-width block for a small dead-half saving
            if n <= nb + nb // 2:
                return matmul_presplit(Ls[:, i:i + n, i:i + n],
                                       lsc[i:i + n], Bs[:, :, i:i + n], bsc)
            n1 = _split(n, nb)
            C1 = rec(i, n1)
            C2 = rec(i + n1, n - n1)
            C2 = C2 + matmul_presplit(Ls[:, i + n1:i + n, i:i + n1],
                                      lsc[i + n1:i + n],
                                      Bs[:, :, i:i + n1], bsc)
            return jnp.concatenate([C1, C2], axis=0)

        return rec(0, L.shape[0])


def _route_complex(A, backend: str) -> bool:
    """Should this operand go through the real-embedding complex path
    (ops/complex_embed.py)?

    - (re, im) pair operands always do (the pair form has no native
      complex array to hand to XLA);
    - complex arrays do only under backend='embed'; 'auto' keeps native
      XLA complex (c64/c128 matmuls and solvers run natively on the GPU).
    The reference treats c/z as first-class in every routine
    (reference include/lapack.h:16-158).
    """
    if isinstance(A, tuple):
        return True
    return is_complex(A.dtype) and backend == "embed"


def _embed_backend(backend: str) -> str:
    """Inner (real-plane) backend for the embedding tier: 'embed' selects
    the embedding itself, so the real ops run on 'auto'; any other
    explicit backend ('ref'/'xla'/'ozaki') is honored."""
    return "auto" if backend in ("auto", "embed") else backend


def _tiles_for(dtype, backend: str):
    """Tile backend of a blocked driver: 'ozaki' → int8-slice f64 tiles;
    'auto' and 'xla' → XLA tiles for every dtype. Unknown backends raise
    through xerbla; nothing is rerouted."""
    dtype = jnp.dtype(dtype)
    backend = _resolve(backend)
    if backend == "embed":
        check(False, "blocked", 0,
              "backend='embed' requires complex operands "
              "(arrays or (re, im) pairs)")
    if backend == "ozaki":
        check(dtype == jnp.dtype(jnp.float64), "blocked", 0,
              f"ozaki backend supports float64 only, got {dtype}")
        return _OzakiTiles()
    return _XlaTiles(dtype)


# ---------------------------------------------------------------------------
# Recursive cores (lower-triangular canonical forms)
# ---------------------------------------------------------------------------

def _split(n: int, nb: int) -> int:
    return ((n // nb + 1) // 2) * nb


def _trsm_rlt(L, B, t, nb):
    """Solve X·Lᴴ = B (right, lower, conj-transposed, non-unit) — the potrf
    panel solve, via the diagonal-inverse trick at the leaves.
    ("C" degrades to plain transpose for real dtypes.)"""
    if hasattr(t, "trsm_rlt"):   # Ozaki: one shared peel of L
        return t.trsm_rlt(L, B, nb)
    n = L.shape[0]
    if n <= nb:
        T, _ = t.trti2(L)
        return t.mm(B, T, tb="C")
    n1 = _split(n, nb)
    L1, M, L2 = L[:n1, :n1], L[n1:, :n1], L[n1:, n1:]
    X1 = _trsm_rlt(L1, B[:, :n1], t, nb)
    B2 = t.mm(X1, M, tb="C", alpha=-1.0, beta=1.0, C=B[:, n1:])
    X2 = _trsm_rlt(L2, B2, t, nb)
    return jnp.concatenate([X1, X2], axis=1)


def _trsm_lln(L, B, t, nb, unit):
    """Solve L·X = B (left, lower, no-trans)."""
    if hasattr(t, "trsm_lln"):   # Ozaki: one shared peel of L
        return t.trsm_lln(L, B, nb, unit)
    n = L.shape[0]
    if n <= nb:
        T, _ = t.trti2(L, unit=unit)
        if unit:
            T = _force_unit_diag(T)
        return t.mm(T, B)
    n1 = _split(n, nb)
    L1, M, L2 = L[:n1, :n1], L[n1:, :n1], L[n1:, n1:]
    X1 = _trsm_lln(L1, B[:n1], t, nb, unit)
    B2 = t.mm(M, X1, alpha=-1.0, beta=1.0, C=B[n1:])
    X2 = _trsm_lln(L2, B2, t, nb, unit)
    return jnp.concatenate([X1, X2], axis=0)


def _trsm_llt(L, B, t, nb, unit):
    """Solve Lᵀ·X = B (left, lower, transposed)."""
    if hasattr(t, "trsm_llt"):   # Ozaki: one shared peel of L
        return t.trsm_llt(L, B, nb, unit)
    n = L.shape[0]
    if n <= nb:
        T, _ = t.trti2(L, unit=unit)
        if unit:
            T = _force_unit_diag(T)
        return t.mm(T, B, ta="T")
    n1 = _split(n, nb)
    L1, M, L2 = L[:n1, :n1], L[n1:, :n1], L[n1:, n1:]
    X2 = _trsm_llt(L2, B[n1:], t, nb, unit)
    B1 = t.mm(M, X2, ta="T", alpha=-1.0, beta=1.0, C=B[:n1])
    X1 = _trsm_llt(L1, B1, t, nb, unit)
    return jnp.concatenate([X1, X2], axis=0)


def _force_unit_diag(T):
    n = T.shape[0]
    return T - jnp.diag(jnp.diag(T)) + jnp.eye(n, dtype=T.dtype)


def _potrf_lower(A, t, nb):
    n = A.shape[0]
    if n <= nb:
        return t.potf2(A)
    n1 = _split(n, nb)
    L11, i1 = _potrf_lower(A[:n1, :n1], t, nb)
    L21 = _trsm_rlt(L11, A[n1:, :n1], t, nb)
    A22 = t.syrk_ln(-1.0, L21, 1.0, A[n1:, n1:])
    L22, i2 = _potrf_lower(A22, t, nb)
    top = jnp.concatenate([L11, jnp.zeros((n1, n - n1), A.dtype)], axis=1)
    bot = jnp.concatenate([L21, L22], axis=1)
    out = jnp.concatenate([top, bot], axis=0)
    info = jnp.where(i1 > 0, i1,
                     jnp.where(i2 > 0, i2 + n1, 0)).astype(jnp.int32)
    return out, info


def _trtri_lower(L, t, nb, unit):
    if hasattr(t, "trtri_lower"):   # Ozaki: one shared peel of L
        return t.trtri_lower(L, nb, unit)
    n = L.shape[0]
    if n <= nb:
        return t.trti2(L, unit=unit)
    n1 = _split(n, nb)
    W1, i1 = _trtri_lower(L[:n1, :n1], t, nb, unit)
    W2, i2 = _trtri_lower(L[n1:, n1:], t, nb, unit)
    W1e = _force_unit_diag(W1) if unit else W1
    W2e = _force_unit_diag(W2) if unit else W2
    # M' = -W₂·M·W₁   (reference strtri.c column-update scheme, collapsed)
    Mp = t.mm(W2e, L[n1:, :n1])
    Mp = t.mm(Mp, W1e, alpha=-1.0)
    top = jnp.concatenate([W1, jnp.zeros((n1, n - n1), L.dtype)], axis=1)
    bot = jnp.concatenate([Mp, W2], axis=1)
    out = jnp.concatenate([top, bot], axis=0)
    info = jnp.where(i1 > 0, i1,
                     jnp.where(i2 > 0, i2 + n1, 0)).astype(jnp.int32)
    return out, info


def _lauum_lower(L, t, nb):
    n = L.shape[0]
    if n <= nb:
        return t.lauu2(L)
    n1 = _split(n, nb)
    M, L2 = L[n1:, :n1], L[n1:, n1:]
    B11 = _lauum_lower(L[:n1, :n1], t, nb)
    conjM = M.conj() if is_complex(L.dtype) else M
    B11 = t.syrk_ln(1.0, conjM.T, 1.0, B11)           # B11 += MᴴM
    L2t = jnp.tril(L2)
    B21 = t.mm(L2t, M, ta="C" if is_complex(L.dtype) else "T")  # L₂ᴴ·M
    B22 = _lauum_lower(L2, t, nb)
    top = jnp.concatenate([B11, jnp.zeros((n1, n - n1), L.dtype)], axis=1)
    bot = jnp.concatenate([B21, B22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


# ---------------------------------------------------------------------------
# Padding helpers (identity-pad is exact for all triangular drivers)
# ---------------------------------------------------------------------------

def _pad_identity(A, nb):
    n = A.shape[0]
    p = _round_up(max(n, nb), nb)
    if p == n:
        return A, n
    Ap = jnp.pad(A, ((0, p - n), (0, p - n)))
    pad_diag = jnp.concatenate([jnp.zeros((n,), A.dtype),
                                jnp.ones((p - n,), A.dtype)])
    return Ap + jnp.diag(pad_diag), n


def _to_lower(A, uplo):
    """Canonicalize: the lower triangle of the returned matrix holds the
    data of the selected triangle of A (conjugated for upper)."""
    return A.conj().T if norm_uplo(uplo) == Uplo.UPPER else A


def _from_lower(R, uplo):
    return R.conj().T if norm_uplo(uplo) == Uplo.UPPER else R


def _merge_triangle(result, original, uplo):
    """Take the uplo triangle from result, the opposite strict triangle
    from the caller's original matrix (reference storage semantics)."""
    if norm_uplo(uplo) == Uplo.LOWER:
        return jnp.tril(result) + jnp.triu(original, 1)
    return jnp.triu(result) + jnp.tril(original, -1)


# ---------------------------------------------------------------------------
# Public LAPACK drivers
# ---------------------------------------------------------------------------

def potrf(uplo, A, backend: str = "auto", block_size: Optional[int] = None):
    """Blocked Cholesky (reference cuSpotrf, lapack/spotrf.c:261-398).
    Returns (A_factored, info).

    Panel solves use recursive substitution (minimal FLOPs); the
    reference's diagonal-inverse trick (hybridSpotrf spotrf.c:252-256)
    lives at the leaves (_trsm_rlt) and in the distributed tier.

    Complex operands route through the real embedding when
    _route_complex says so (pairs, or backend='embed')."""
    if _route_complex(A, backend):
        from cholesky_tpu.ops import complex_embed
        return complex_embed.potrf_split(uplo, A, backend=_embed_backend(backend),
                                         block_size=block_size)
    uplo = norm_uplo(uplo)
    n = lapack_ref._square(A, "potrf")
    if backend == "ref":
        return lapack_ref.potrf(uplo, A)
    t = _tiles_for(A.dtype, backend)
    nb = block_size or t.default_nb
    if n == 0:
        return A, jnp.int32(0)
    W = _to_lower(A, uplo)
    Wp, _ = _pad_identity(W, nb)
    F, info = _potrf_lower(Wp, t, nb)
    F = F[:n, :n]
    return _merge_triangle(_from_lower(F, uplo), A, uplo), info


def potf2(uplo, A, backend: str = "auto", **kw):
    """Unblocked Cholesky of one diagonal block: the XLA-tile leaf under
    'auto'/'xla' (the on-device diagonal factor of the reference's
    spotf2, spotrf.cu:26-107), the oracle sweep otherwise. Complex
    operands routed by _route_complex go through the embedding driver."""
    if _route_complex(A, backend):
        from cholesky_tpu.ops import complex_embed
        return complex_embed.potrf_split(uplo, A,
                                         backend=_embed_backend(backend))
    u = norm_uplo(uplo)
    n = lapack_ref._square(A, "potf2")
    if _resolve(backend) in ("auto", "xla") and n > 0:
        L, info = _XlaTiles(A.dtype).potf2(_to_lower(A, u))
        return _merge_triangle(_from_lower(L, u), A, u), info
    return lapack_ref.potf2(uplo, A)


def trti2(uplo, diag, A, backend: str = "auto", **kw):
    """Unblocked triangular inverse of one diagonal block. Complex
    operands routed by _route_complex ((re, im) pairs, backend='embed')
    go through the embedding driver."""
    if _route_complex(A, backend):
        from cholesky_tpu.ops import complex_embed
        return complex_embed.trtri_split(uplo, diag, A,
                                         backend=_embed_backend(backend))
    return lapack_ref.trti2(uplo, diag, A)


def lauu2(uplo, A, backend: str = "auto", **kw):
    """Unblocked triangular square of one diagonal block; complex routing
    as in :func:`trti2`."""
    if _route_complex(A, backend):
        from cholesky_tpu.ops import complex_embed
        return complex_embed.lauum_split(uplo, A,
                                         backend=_embed_backend(backend))
    return lapack_ref.lauu2(uplo, A)


def trtri(uplo, diag, A, backend: str = "auto",
          block_size: Optional[int] = None):
    """Blocked triangular inverse (reference cuStrtri, strtri.c:369-472)."""
    if _route_complex(A, backend):
        from cholesky_tpu.ops import complex_embed
        return complex_embed.trtri_split(uplo, diag, A, backend=_embed_backend(backend),
                                         block_size=block_size)
    uplo = norm_uplo(uplo)
    diag = norm_diag(diag)
    n = lapack_ref._square(A, "trtri")
    if backend == "ref":
        return lapack_ref.trtri(uplo, diag, A)
    t = _tiles_for(A.dtype, backend)
    nb = block_size or t.default_nb
    if n == 0:
        return A, jnp.int32(0)
    unit = diag == Diag.UNIT
    Wp, _ = _pad_identity(_to_lower(A, uplo), nb)
    R, info = _trtri_lower(Wp, t, nb, unit)
    R = R[:n, :n]
    if unit:
        # LAPACK contract: unit-diagonal entries pass through untouched
        R = jnp.tril(R, -1) + jnp.diag(jnp.diag(_to_lower(A, uplo)))
    return _merge_triangle(_from_lower(R, uplo), A, uplo), info


def trtri2(uplo, diag, A, backend: str = "auto", **kw):
    """Out-of-place variant (reference strtri2): identical computation in
    functional JAX."""
    return trtri(uplo, diag, A, backend=backend, **kw)


def lauum(uplo, A, backend: str = "auto", block_size: Optional[int] = None):
    """Blocked triangular square (reference cuSlauum, slauum.c:197-305)."""
    if _route_complex(A, backend):
        from cholesky_tpu.ops import complex_embed
        return complex_embed.lauum_split(uplo, A, backend=_embed_backend(backend),
                                         block_size=block_size)
    uplo = norm_uplo(uplo)
    n = lapack_ref._square(A, "lauum")
    if backend == "ref":
        return lapack_ref.lauum(uplo, A)
    t = _tiles_for(A.dtype, backend)
    nb = block_size or t.default_nb
    if n == 0:
        return A
    Wp, _ = _pad_identity(_to_lower(A, uplo), nb)
    R = _lauum_lower(Wp, t, nb)[:n, :n]
    return _merge_triangle(_from_lower(R, uplo), A, uplo)


def potri(uplo, A, backend: str = "auto", block_size: Optional[int] = None):
    """SPD/HPD inverse from the Cholesky factor: trtri ∘ lauum, the same
    pure composition as every tier of the reference (spotri.c)."""
    W, info = trtri(uplo, Diag.NON_UNIT, A, backend=backend,
                    block_size=block_size)
    return lauum(uplo, W, backend=backend, block_size=block_size), info


def logdet(uplo, A, backend: str = "auto", block_size: Optional[int] = None):
    """Fused SPD log-determinant: blocked potrf + log-diag reduction
    (reference cuSlogdet slogdet.cu reduction, collapsed into an XLA-fused
    epilogue)."""
    if _route_complex(A, backend):
        from cholesky_tpu.ops import complex_embed
        return complex_embed.logdet_split(uplo, A,
                                          backend=_embed_backend(backend),
                                          block_size=block_size)
    F, info = potrf(uplo, A, backend=backend, block_size=block_size)
    return lapack_ref.logdet_from_factor(F), info


# ---------------------------------------------------------------------------
# Public BLAS wrappers over the fast tiles
# ---------------------------------------------------------------------------

def _static_scalar(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _static_scalar_cx(x) -> bool:
    """Static scalar for the embedding tier — complex allowed (the
    reference's c/z BLAS takes complex alpha/beta)."""
    return isinstance(x, (int, float, complex)) and not isinstance(x, bool)


def _check_no_stray_pairs(name, *operands):
    """Pair operands that did not route to the embedding (e.g. traced
    alpha) must fail with a clean xerbla-style error, not an
    AttributeError deep inside the real-dtype drivers."""
    for X in operands:
        check(not isinstance(X, tuple), name, 0,
              "(re, im) pair operands require static Python-number "
              "alpha/beta so the embedding tier can trace them")


def _fast_tiles_or_none(dtype, backend: str):
    """Tile backend for the BLAS wrappers, or None to use blas_ref:
    real dtypes → XLA tiles under 'auto'/'xla'; f64 → Ozaki tiles under
    'ozaki'. Complex is routed to the embedding BEFORE this is consulted
    (_route_complex); complex reaching here runs natively through
    blas_ref. Unknown backends raise through xerbla."""
    dtype = jnp.dtype(dtype)
    backend = _resolve(backend)
    if backend == "embed":
        check(False, "blocked", 0,
              "backend='embed' requires complex operands "
              "(arrays or (re, im) pairs)")
    if is_complex(dtype):
        return None
    if backend == "ozaki":
        return _OzakiTiles() if dtype == jnp.dtype(jnp.float64) else None
    if backend in ("auto", "xla"):
        return _XlaTiles(dtype)
    return None


def gemm(transa, transb, alpha, A, B, beta, C, backend: str = "auto"):
    if _route_complex(A, backend) and _static_scalar_cx(alpha) \
            and _static_scalar_cx(beta):
        from cholesky_tpu.ops import complex_embed
        return complex_embed.gemm_split(transa, transb, alpha, A, B, beta,
                                        C, backend=_embed_backend(backend))
    _check_no_stray_pairs("gemm", A, B, C)
    transa, transb = norm_trans(transa), norm_trans(transb)
    t = _fast_tiles_or_none(A.dtype, backend) \
        if _static_scalar(alpha) and _static_scalar(beta) else None
    if t is not None:
        oA = blas_ref.op(A, transa)
        oB = blas_ref.op(B, transb)
        check(oA.shape[1] == oB.shape[0], "gemm", 5, "inner dims")
        check(C.shape == (oA.shape[0], oB.shape[1]), "gemm", 7, "C shape")
        return t.mm(oA, oB, alpha=alpha, beta=beta,
                    C=C if beta != 0.0 else None)
    return blas_ref.gemm(transa, transb, alpha, A, B, beta, C)


def gemm2(transa, transb, alpha, A, B, beta, C, backend: str = "auto"):
    return gemm(transa, transb, alpha, A, B, beta, C, backend=backend)


def syrk(uplo, trans, alpha, A, beta, C, backend: str = "auto"):
    check(not isinstance(A, tuple) and not isinstance(C, tuple), "syrk", 4,
          "complex rank-k update is HERK — the reference implements no "
          "csyrk/zsyrk (include/blas.h:57-66); use herk/cherk/zherk")
    uplo = norm_uplo(uplo)
    trans = norm_trans(trans)
    t = _fast_tiles_or_none(A.dtype, backend) \
        if _static_scalar(alpha) and _static_scalar(beta) else None
    if t is not None:
        X = A if trans == Trans.NO_TRANS else A.T
        # full product, then the uplo triangle over the caller's C
        # (syrk_ln: one peel serves both sides on the Ozaki tiles)
        full = t.syrk_ln(alpha, X, beta, C)
        return _merge_triangle(full, C, uplo)
    return blas_ref.syrk(uplo, trans, alpha, A, beta, C)


def herk(uplo, trans, alpha, A, beta, C, backend: str = "auto"):
    if _route_complex(A, backend) and _static_scalar(alpha) \
            and _static_scalar(beta):
        from cholesky_tpu.ops import complex_embed
        return complex_embed.herk_split(uplo, trans, alpha, A, beta, C,
                                        backend=_embed_backend(backend))
    _check_no_stray_pairs("herk", A, C)
    if not is_complex(A.dtype):
        tr = "N" if norm_trans(trans) == Trans.NO_TRANS else "T"
        return syrk(uplo, tr, alpha, A, beta, C, backend=backend)
    return blas_ref.herk(uplo, trans, alpha, A, beta, C)


def trmm(side, uplo, transa, diag, alpha, A, B, backend: str = "auto"):
    if _route_complex(A, backend) and _static_scalar_cx(alpha):
        from cholesky_tpu.ops import complex_embed
        return complex_embed.trmm_split(side, uplo, transa, diag, alpha,
                                        A, B, backend=_embed_backend(backend))
    _check_no_stray_pairs("trmm", A, B)
    side = norm_side(side)
    uplo = norm_uplo(uplo)
    transa = norm_trans(transa)
    t = _fast_tiles_or_none(A.dtype, backend) \
        if _static_scalar(alpha) else None
    if t is not None:
        # structure-exploiting recursion over the tiles: only live blocks
        # of the triangle are multiplied — about half the matmul work of
        # a masked full GEMM. All side/uplo/trans combos canonicalize onto
        # the ONE (left, lower, no-trans) recursion via O(n²) transposes
        # and reversals (the reference writes one kernel per combo,
        # blas/strmm.cu, dtrmm.cu, ztrmm.cu:73-1005).
        M = blas_ref._tri(A, uplo, diag)
        if side == Side.RIGHT:     # B·op(M) = (op(M)ᵀ·Bᵀ)ᵀ, real dtypes
            return _trmm_left_tiles(t, M, uplo, _flip_trans(transa),
                                    B.T, alpha).T
        return _trmm_left_tiles(t, M, uplo, transa, B, alpha)
    return blas_ref.trmm(side, uplo, transa, diag, alpha, A, B)


def _flip_trans(transa):
    return (Trans.TRANS if norm_trans(transa) == Trans.NO_TRANS
            else Trans.NO_TRANS)        # T and C coincide for real dtypes


# leaf width for the live-block trmm recursion: large enough that each
# leaf matmul (and the Ozaki slice-split per call) is efficient, small
# enough that the dead half of the leaf (~nb/2n of the total) stays minor
TRMM_TILES_NB = 512


def _trmm_lln_tiles(L, B, t, nb):
    """L·B with L an exactly-triangular lower matrix, via live-block
    recursion over the ``t`` tile backend: the dead upper blocks are never
    multiplied. Backends with a ``trmm_lln`` method (Ozaki: hoists the
    slice peel out of the recursion) take over the whole triangle."""
    if hasattr(t, "trmm_lln"):
        return t.trmm_lln(L, B, nb)
    n = L.shape[0]
    if n <= nb + nb // 2:   # ragged-tail absorption, as in trmm_lln
        return t.mm(L, B)
    n1 = _split(n, nb)
    C1 = _trmm_lln_tiles(L[:n1, :n1], B[:n1], t, nb)
    C2 = _trmm_lln_tiles(L[n1:, n1:], B[n1:], t, nb)
    C2 = t.mm(L[n1:, :n1], B[:n1], beta=1.0, C=C2)
    return jnp.concatenate([C1, C2], axis=0)


def _trmm_left_tiles(t, M, uplo, transa, B, alpha, nb: int = None):
    """op(M)·B over generic tiles; real dtypes only (complex trmm routes
    through the embedding's own live-block recursion,
    complex_embed.trmm_split). op(M) is lower iff (lower, N) or
    (upper, T); upper forms reduce to lower by the double-reversal
    identity U·B = flipud(rev2(U) · flipud(B)) with rev2(U) lower."""
    nb = TRMM_TILES_NB if nb is None else nb    # module attr, patchable
    check(not is_complex(M.dtype), "trmm", 6,
          "complex trmm must route through the embedding tier")
    tr = norm_trans(transa)
    E = M if tr == Trans.NO_TRANS else M.T      # T == C for real dtypes
    e_lower = (norm_uplo(uplo) == Uplo.LOWER) == (tr == Trans.NO_TRANS)
    if e_lower:
        out = _trmm_lln_tiles(E, B, t, nb)
    else:
        out = _trmm_lln_tiles(E[::-1, ::-1], B[::-1, :], t, nb)[::-1, :]
    return out if alpha == 1.0 else alpha * out


def trmm2(side, uplo, transa, diag, alpha, A, B, backend: str = "auto"):
    return trmm(side, uplo, transa, diag, alpha, A, B, backend=backend)


def trsm(side, uplo, transa, diag, alpha, A, B, backend: str = "auto",
         block_size: Optional[int] = None):
    """Blocked triangular solve via the diagonal-inverse trick
    (reference cuStrsm / hybridSpotrf panel substitution)."""
    if _route_complex(A, backend):
        from cholesky_tpu.ops import complex_embed
        check(_static_scalar_cx(alpha), "trsm", 5,
              "complex trsm via the embedding needs a static scalar alpha")
        return complex_embed.trsm_split(side, uplo, transa, diag, alpha,
                                        A, B, backend=_embed_backend(backend),
                                        block_size=block_size)
    side = norm_side(side)
    uplo = norm_uplo(uplo)
    transa = norm_trans(transa)
    diag = norm_diag(diag)
    t = _fast_tiles_or_none(A.dtype, backend) \
        if _static_scalar(alpha) else None
    if t is None:
        return blas_ref.trsm(side, uplo, transa, diag, alpha, A, B)
    # real dtypes only past this point (_route_complex intercepted complex
    # above): the CONJ_TRANS→NO_TRANS flips below degenerate Cᵀ to plain
    # transpose, which is WRONG for complex operands — guard the invariant
    check(not is_complex(A.dtype), "trsm", 6,
          "complex trsm must route through the embedding tier")
    nb = block_size or t.default_nb
    unit = diag == Diag.UNIT
    # canonicalize: side=R → transposed left solve; upper → lower on Aᵀ
    if side == Side.RIGHT:
        flip = {Trans.NO_TRANS: Trans.TRANS, Trans.TRANS: Trans.NO_TRANS,
                Trans.CONJ_TRANS: Trans.NO_TRANS}[transa]
        out = trsm(Side.LEFT, uplo, flip, diag, alpha, A, B.T,
                   backend=backend, block_size=block_size)
        return out.T
    if uplo == Uplo.UPPER:
        flip = {Trans.NO_TRANS: Trans.TRANS, Trans.TRANS: Trans.NO_TRANS,
                Trans.CONJ_TRANS: Trans.NO_TRANS}[transa]
        return trsm(Side.LEFT, Uplo.LOWER, flip, diag, alpha, A.T, B,
                    backend=backend, block_size=block_size)

    check(A.shape[0] == B.shape[0], "trsm", 6, "dim mismatch")
    Lp, n = _pad_identity(jnp.tril(A) if not unit else
                          jnp.tril(A, -1) + jnp.eye(A.shape[0], dtype=A.dtype),
                          nb)
    Bp = jnp.pad(B, ((0, Lp.shape[0] - n), (0, 0))) if Lp.shape[0] != n else B
    Bp = alpha * Bp if alpha != 1.0 else Bp
    if transa == Trans.NO_TRANS:
        X = _trsm_lln(Lp, Bp, t, nb, unit=False)
    else:
        X = _trsm_llt(Lp, Bp, t, nb, unit=False)
    return X[:n]
