"""Complex routines via the interleaved real embedding.

The reference *hand-splits* complex into real/imag planes in shared memory
(reference cgemm.cu:7-15 split-storage + cuCfmaf fusion). This module is
the structural analog — selected by ``backend='embed'`` or by passing
(re, im) pair operands; 'auto' runs complex natively — built on a
classical identity:

Embed each complex entry a+bi as the 2×2 real block [[a, -b], [b, a]]
(interleaved layout). The map E is a *-algebra homomorphism:
    E(X·Y) = E(X)·E(Y),  E(Xᴴ) = E(X)ᵀ,  E(X⁻¹) = E(X)⁻¹.
For an HPD matrix A, E(A) is SPD, and because the diagonal of a complex
Cholesky factor is real, E(L) is *lower triangular* — so

    chol(E(A)) = E(chol(A))        (exactly, by uniqueness)

and likewise trtri/lauum/potri/trsm commute with E. Complex drivers
therefore reduce to the library's REAL drivers at size 2n: complex64
rides the f32 tiles, complex128 the f64 tiles, and operands may travel as
(re, im) real pairs that never form a complex array.

Cost: a real 2n potrf is 8n³/3 real flops vs 4n³/3 for ideal complex —
a 2× overhead (the reference's split makes a similar trade: extra
shared-memory traffic to keep the FMA pipes busy).

logdet: det(E(A)) = |det(A)|² = det(A)² for HPD ⇒ logdet(A) = ½·logdet(E(A)).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from cholesky_tpu.types import Uplo, Diag, norm_diag, norm_uplo
from cholesky_tpu.ops import blocked


def _row_interleave(X, Y):
    """(n,m) × (n,m) → (2n,m) with rows alternating X_i, Y_i, through one
    (n,2,m) intermediate."""
    n, m = X.shape
    return jnp.stack([X, Y], axis=1).reshape(2 * n, m)


def _row_deinterleave(M):
    """(2n,m) → even rows (n,m), odd rows (n,m); inverse of interleave."""
    n2, m = M.shape
    B = M.reshape(n2 // 2, 2, m)
    return B[:, 0, :], B[:, 1, :]


def embed(re, im):
    """(n,m) real/imag planes → (2n,2m) interleaved real embedding,
    built from 2-D row interleaves only (column interleave = transposed
    row interleave) so no intermediate carries a trailing dim of 2."""
    P = _row_interleave(re, im)      # per-block column 0: [a; b]
    Q = _row_interleave(-im, re)     # per-block column 1: [-b; a]
    return _row_interleave(P.T, Q.T).T


def unembed(M) -> Tuple[jax.Array, jax.Array]:
    """(2n,2m) interleaved embedding → (re, im) planes (reads the a / b
    positions; exact inverse of :func:`embed` on embedded matrices)."""
    even, odd = _row_deinterleave(M)
    re = _row_deinterleave(even.T)[0].T
    im = _row_deinterleave(odd.T)[0].T
    return re, im


def _split(A):
    if isinstance(A, tuple):
        return A
    return A.real, A.imag


def _merge_triangle_planes(rr, ri, ar, ai, uplo):
    """Selected triangle from the result planes, opposite strict triangle
    from the caller's planes (public-driver storage contract, same as
    blocked._merge_triangle)."""
    if norm_uplo(uplo) == Uplo.LOWER:
        return (jnp.tril(rr) + jnp.triu(ar, 1),
                jnp.tril(ri) + jnp.triu(ai, 1))
    return (jnp.triu(rr) + jnp.tril(ar, -1),
            jnp.triu(ri) + jnp.tril(ai, -1))


def _scale_planes(alpha, rr, ri):
    """(re, im) planes of alpha·(rr + i·ri) for a static Python scalar
    (complex allowed — the reference's c/z routines take complex alpha,
    e.g. cuCgemm include/blas.h:180-190)."""
    a = complex(alpha)
    if a.imag == 0.0:
        return a.real * rr, a.real * ri
    return a.real * rr - a.imag * ri, a.real * ri + a.imag * rr


def _merge(re, im, like):
    if isinstance(like, tuple):
        return re, im
    return jax.lax.complex(re, im).astype(like.dtype)


def potrf_split(uplo, A, backend: str = "auto",
                block_size: Optional[int] = None):
    """Complex Cholesky via the real embedding. ``A`` is a complex array or
    an (re, im) pair of real arrays;
    the result matches the input form. Returns (factor, info); info indexes
    the complex pivot (1-based). The opposite strict triangle of the
    caller's matrix passes through (public-driver storage contract)."""
    uplo = norm_uplo(uplo)
    re0, im0 = _split(A)
    re, im = re0, im0
    if uplo == Uplo.UPPER:
        # lower-canonicalize: conj transpose ⇒ (reᵀ, −imᵀ)
        re, im = re.T, -im.T
    M = embed(re, im)
    F, info_e = blocked.potrf(Uplo.LOWER, M, backend=backend,
                              block_size=block_size)
    fr, fi = unembed(jnp.tril(F))
    # embedded pivot 2k−1 or 2k ↦ complex pivot k
    info = jnp.where(info_e > 0, (info_e + 1) // 2, 0).astype(jnp.int32)
    if uplo == Uplo.UPPER:
        fr, fi = fr.T, -fi.T
    fr, fi = _merge_triangle_planes(fr, fi, re0, im0, uplo)
    return _merge(fr, fi, A), info


def _real_diag_form(re, im):
    """Factor a complex lower-triangular L as U·L′ with U = diag(d/|d|)
    unitary and L′ = diag-scaled L having a REAL positive diagonal —
    E(L′) is then genuinely lower triangular (the raw embedding of a
    complex-diagonal triangular matrix is NOT: the 2×2 diagonal blocks
    carry −Im d above the diagonal, which the real drivers' tril would
    destroy). Exact elementwise transform. Returns (re′, im′, ur, ui)
    with u = conj(d)/|d| (so L′ rows = u ⊙ L rows; U⁻¹ = diag(u))."""
    dr, di = jnp.diag(re), jnp.diag(im)
    mag = jnp.sqrt(dr * dr + di * di)
    safe = jnp.where(mag == 0, jnp.ones_like(mag), mag)
    ur = jnp.where(mag == 0, jnp.ones_like(mag), dr / safe)
    ui = jnp.where(mag == 0, jnp.zeros_like(mag), -di / safe)
    rep = re * ur[:, None] - im * ui[:, None]
    imp = re * ui[:, None] + im * ur[:, None]
    return rep, imp, ur, ui


def trtri_split(uplo, diag, A, backend: str = "auto",
                block_size: Optional[int] = None):
    """Complex triangular inverse via the embedding (E(X⁻¹) = E(X)⁻¹),
    with the unitary-diagonal factorization making the embedding
    triangular: L⁻¹ = L′⁻¹·diag(u)."""
    uplo = norm_uplo(uplo)
    diag = norm_diag(diag)
    re0, im0 = _split(A)
    re, im = re0, im0
    if uplo == Uplo.UPPER:
        re, im = re.T, -im.T
    if diag == Diag.UNIT:
        rep, imp, ur, ui = re, im, None, None
    else:
        rep, imp, ur, ui = _real_diag_form(re, im)
    M = embed(rep, imp)
    W, info_e = blocked.trtri(Uplo.LOWER, diag, M, backend=backend,
                              block_size=block_size)
    wr, wi = unembed(jnp.tril(W))
    if diag != Diag.UNIT:
        # post-scale columns by u = conj(d)/|d|:
        # W′ has diag 1/|d| ⇒ scaled diag = conj(d)/|d|² = 1/d ✓
        wr, wi = wr * ur[None, :] - wi * ui[None, :], \
            wr * ui[None, :] + wi * ur[None, :]
    info = jnp.where(info_e > 0, (info_e + 1) // 2, 0).astype(jnp.int32)
    if uplo == Uplo.UPPER:
        wr, wi = wr.T, -wi.T
    wr, wi = _merge_triangle_planes(wr, wi, re0, im0, uplo)
    return _merge(wr, wi, A), info


def lauum_split(uplo, A, backend: str = "auto",
                block_size: Optional[int] = None):
    """Complex Lᴴ·L / U·Uᴴ via the embedding. Uses LᴴL = L′ᴴL′ where
    L′ = diag(conj(d)/|d|)·L has a real diagonal (unitary row scaling
    cancels in the Hermitian product)."""
    uplo = norm_uplo(uplo)
    re0, im0 = _split(A)
    re, im = re0, im0
    if uplo == Uplo.UPPER:
        re, im = re.T, -im.T
    rep, imp, _, _ = _real_diag_form(re, im)
    M = embed(rep, imp)
    R = blocked.lauum(Uplo.LOWER, M, backend=backend, block_size=block_size)
    # result is Hermitian ⇒ embedded result symmetric; lower triangle valid
    Rfull = jnp.tril(R) + jnp.tril(R, -1).T
    rr, ri = unembed(Rfull)
    if uplo == Uplo.UPPER:
        rr, ri = rr.T, -ri.T
    rr, ri = _merge_triangle_planes(rr, ri, re0, im0, uplo)
    return _merge(rr, ri, A)


def potri_split(uplo, A, backend: str = "auto",
                block_size: Optional[int] = None):
    W, info = trtri_split(uplo, Diag.NON_UNIT, A, backend=backend,
                          block_size=block_size)
    return lauum_split(uplo, W, backend=backend, block_size=block_size), info


def logdet_split(uplo, A, backend: str = "auto",
                 block_size: Optional[int] = None):
    """Complex HPD log|det| via the embedding: ½·logdet(E(A))."""
    uplo = norm_uplo(uplo)
    re, im = _split(A)
    if uplo == Uplo.UPPER:
        re, im = re.T, -im.T
    M = embed(re, im)
    val, info_e = blocked.logdet(Uplo.LOWER, M, backend=backend,
                                 block_size=block_size)
    info = jnp.where(info_e > 0, (info_e + 1) // 2, 0).astype(jnp.int32)
    return 0.5 * val, info


def _op_planes(re, im, trans):
    """Apply op (N/T/C) to a complex matrix given as planes."""
    from cholesky_tpu.types import Trans, norm_trans
    t = norm_trans(trans)
    if t == Trans.NO_TRANS:
        return re, im
    if t == Trans.TRANS:
        return re.T, im.T
    return re.T, -im.T


def gemm_split(transa, transb, alpha, A, B, beta, C, backend: str = "auto"):
    """Complex GEMM via the embedding: E(α·op(A)·op(B) + β·C) =
    α·E(op A)·E(op B) + β·E(C) — one real GEMM at 2× each dimension on the
    real tiles (c64 → f32, c128 → f64). This is the analog of the
    reference's split-storage complex kernels
    (reference blas/cgemm.cu:7-15, zgemm.cu). α, β static scalars —
    complex allowed (reference cgemm takes complex alpha/beta,
    include/blas.h:180-190). Operands are complex arrays or (re, im)
    pairs; the result matches C's form."""
    al, be = complex(alpha), complex(beta)
    ar, ai = _op_planes(*_split(A), transa)
    br, bi = _op_planes(*_split(B), transb)
    cr, ci = _split(C)
    if al.imag == 0.0 and be.imag == 0.0:
        out = blocked.gemm("N", "N", al.real, embed(ar, ai), embed(br, bi),
                           be.real, embed(cr, ci), backend=backend)
        rr, ri = unembed(out)
        return _merge(rr, ri, C)
    # complex scalars: unit-scalar product, then the affine combine in
    # pair space (α·P + β·C)
    out = blocked.gemm("N", "N", 1.0, embed(ar, ai), embed(br, bi),
                       0.0, embed(cr, ci), backend=backend)
    pr, pi = unembed(out)
    sr, si = _scale_planes(al, pr, pi)
    tr_, ti_ = _scale_planes(be, cr, ci)
    return _merge(sr + tr_, si + ti_, C)


def herk_split(uplo, trans, alpha, A, beta, C, backend: str = "auto"):
    """Complex HERK via the embedding: with X = op(A),
    E(α·X·Xᴴ + β·C) = α·E(X)·E(X)ᵀ + β·E(C) — a real symmetric rank-k
    update (reference cuCherk/cuZherk, blas/cherk.cu). α, β real. Only the
    selected triangle of C is read; the result diagonal is exactly real
    and the opposite strict triangle of the caller's C passes through."""
    from cholesky_tpu.types import Trans, norm_trans
    uplo = norm_uplo(uplo)
    t = norm_trans(trans)
    xr, xi = _op_planes(*_split(A), "N" if t == Trans.NO_TRANS else "C")
    cr, ci = _split(C)
    # Hermitian completion of the selected triangle (reads only it)
    if uplo == Uplo.LOWER:
        hr = jnp.tril(cr) + jnp.tril(cr, -1).T
        hi = jnp.tril(ci, -1) - jnp.tril(ci, -1).T
    else:
        hr = jnp.triu(cr) + jnp.triu(cr, 1).T
        hi = jnp.triu(ci, 1) - jnp.triu(ci, 1).T
    EX = embed(xr, xi)
    out = blocked.gemm("N", "T", alpha, EX, EX, beta, embed(hr, hi),
                       backend=backend)
    rr, ri = unembed(out)
    # exact-real diagonal (herk contract), caller triangle restored
    ri = ri - jnp.diag(jnp.diag(ri))
    rr, ri = _merge_triangle_planes(rr, ri, cr, ci, uplo)
    return _merge(rr, ri, C)


# leaf width for the live-block complex trmm recursion (the embedded real
# GEMM runs at 2n, so a 512 complex leaf is a 1024 real multiply)
_TRMM_PLANES_NB = 512


def _trmm_lln_planes(tr, ti, br, bi, backend, nb=_TRMM_PLANES_NB):
    """L·B for an exactly-lower-triangular complex L given as planes, via
    live-block recursion: diagonal blocks recurse, the off-diagonal dense
    block is ONE embedded real GEMM — the dead upper blocks are never
    multiplied (~half the embedded-matmul work of a full embedding).
    The complex-level analog of blocked._trmm_lln_tiles and the
    reference's triangle-aware ztrmm (blas/ztrmm.cu:73-1005)."""
    n = tr.shape[0]
    if n <= nb + nb // 2:   # ragged-tail absorption (blocked.trmm_lln)
        EB = embed(br, bi)
        out = blocked.gemm("N", "N", 1.0, embed(tr, ti), EB, 0.0,
                           jnp.zeros_like(EB), backend=backend)
        return unembed(out)
    n1 = blocked._split(n, nb)
    c1r, c1i = _trmm_lln_planes(tr[:n1, :n1], ti[:n1, :n1],
                                br[:n1], bi[:n1], backend, nb)
    c2r, c2i = _trmm_lln_planes(tr[n1:, n1:], ti[n1:, n1:],
                                br[n1:], bi[n1:], backend, nb)
    out = blocked.gemm("N", "N", 1.0,
                       embed(tr[n1:, :n1], ti[n1:, :n1]),
                       embed(br[:n1], bi[:n1]),
                       1.0, embed(c2r, c2i), backend=backend)
    c2r, c2i = unembed(out)
    return (jnp.concatenate([c1r, c2r], axis=0),
            jnp.concatenate([c1i, c2i], axis=0))


def trmm_split(side, uplo, transa, diag, alpha, A, B, backend: str = "auto"):
    """Complex TRMM via the embedding: mask the triangle (and unit
    diagonal) at the COMPLEX level, canonicalize every side/uplo/trans
    combo onto the (left, lower, no-trans) live-block recursion, and
    multiply only live blocks through embedded real GEMMs (reference
    cuCtrmm2/cuZtrmm2, blas/ztrmm.cu:73-1005 — triangle-aware in every
    dtype). α static (complex allowed — scaled in pair space)."""
    from cholesky_tpu.types import Side, Trans, norm_side, norm_trans
    side = norm_side(side)
    uplo = norm_uplo(uplo)
    diag = norm_diag(diag)
    transa = norm_trans(transa)
    ar, ai = _split(A)
    if uplo == Uplo.LOWER:
        tr, ti = jnp.tril(ar), jnp.tril(ai)
    else:
        tr, ti = jnp.triu(ar), jnp.triu(ai)
    if diag == Diag.UNIT:
        n = tr.shape[0]
        tr = tr - jnp.diag(jnp.diag(tr)) + jnp.eye(n, dtype=tr.dtype)
        ti = ti - jnp.diag(jnp.diag(ti))
    br, bi = _split(B)
    if side == Side.LEFT:
        er, ei = _op_planes(tr, ti, transa)
        transposed = transa != Trans.NO_TRANS
    else:
        # B·op(T) = (op(T)ᵀ·Bᵀ)ᵀ with PLAIN transposes (valid over ℂ):
        # op(T)ᵀ = Tᵀ (N) / T (T) / conj(T) (C)
        if transa == Trans.NO_TRANS:
            er, ei = tr.T, ti.T
            transposed = True
        elif transa == Trans.TRANS:
            er, ei = tr, ti
            transposed = False
        else:
            er, ei = tr, -ti
            transposed = False
        br, bi = br.T, bi.T
    e_lower = (uplo == Uplo.LOWER) != transposed
    if e_lower:
        rr, ri = _trmm_lln_planes(er, ei, br, bi, backend)
    else:
        rr, ri = _trmm_lln_planes(er[::-1, ::-1], ei[::-1, ::-1],
                                  br[::-1, :], bi[::-1, :], backend)
        rr, ri = rr[::-1, :], ri[::-1, :]
    if side == Side.RIGHT:
        rr, ri = rr.T, ri.T
    rr, ri = _scale_planes(alpha, rr, ri)
    return _merge(rr, ri, B)


def _trsm_lower_left(ar, ai, br, bi, trans, unit, backend, block_size):
    """Solve op(L)·X = B for complex lower-triangular L given as planes,
    via the real-diagonal factorization L = U·L′ (U = diag(d/|d|)):
      N: X = L′⁻¹ (U⁻¹B)      — pre-scale rows by u = conj(d)/|d|
      C: X = U (L′ᴴ)⁻¹ B      — post-scale rows by conj(u)
      T: conj(L)ᴴ X = B       — embed conj, solve as 'C' of conj(L)
    """
    if trans == "T":
        xr, xi = _trsm_lower_left(ar, -ai, br, bi, "C", unit,
                                  backend, block_size)
        return xr, xi
    if unit:
        rep, imp, ur, ui = ar, ai, None, None
    else:
        rep, imp, ur, ui = _real_diag_form(ar, ai)
    if trans == "N" and not unit:
        br, bi = br * ur[:, None] - bi * ui[:, None], \
            br * ui[:, None] + bi * ur[:, None]
    MA = embed(rep, imp)
    MB = embed(br, bi)
    X = blocked.trsm("L", "L", "N" if trans == "N" else "T",
                     "U" if unit else "N", 1.0, MA, MB,
                     backend=backend, block_size=block_size)
    xr, xi = unembed(X)
    if trans == "C" and not unit:
        # post-scale rows by conj(u) = d/|d|
        xr, xi = xr * ur[:, None] + xi * ui[:, None], \
            xi * ur[:, None] - xr * ui[:, None]
    return xr, xi


def trsm_split(side, uplo, transa, diag, alpha, A, B, backend: str = "auto",
               block_size: Optional[int] = None):
    """Complex triangular solve via the embedding. ``A``/``B`` are complex
    arrays or (re, im) pairs; ``alpha`` is a static scalar (complex
    allowed — X is linear in B, so the rhs planes are pre-scaled).
    All side/uplo/trans/diag
    combinations are canonicalized at the complex level (the raw embedding
    of an upper-triangular complex matrix is not upper triangular, so
    canonicalization must precede embedding)."""
    from cholesky_tpu.types import Side, Trans, norm_side, norm_trans
    side = norm_side(side)
    uplo = norm_uplo(uplo)
    transa = norm_trans(transa)
    diag = norm_diag(diag)
    ar, ai = _split(A)
    br, bi = _split(B)
    br, bi = _scale_planes(alpha, br, bi)
    t = {Trans.NO_TRANS: "N", Trans.TRANS: "T", Trans.CONJ_TRANS: "C"}[transa]

    # side=R → left solve on transposes: X·op(A) = B ⟺ op(A)ᵀXᵀ = Bᵀ
    if side == Side.RIGHT:
        flip = {"N": "T", "T": "N", "C": "CONJ"}[t]
        if flip == "CONJ":
            out = trsm_split(Side.LEFT, uplo, "N", diag, 1.0,
                             (ar, ai), (br.T, -bi.T),
                             backend=backend, block_size=block_size)
            orr, oi = out if isinstance(out, tuple) else (out.real, out.imag)
            return _merge(orr.T, -oi.T, B)
        out = trsm_split(Side.LEFT, uplo, flip, diag, 1.0,
                         (ar, ai), (br.T, bi.T),
                         backend=backend, block_size=block_size)
        orr, oi = out if isinstance(out, tuple) else (out.real, out.imag)
        return _merge(orr.T, oi.T, B)

    # uplo=U → lower via A′ = Aᴴ:  U = A′ᴴ
    if uplo == Uplo.UPPER:
        ar, ai = ar.T, -ai.T
        t = {"N": "C",   # U·X = A′ᴴ·X ⇒ op C on A′
             "T": "TU",  # Uᵀ·X = conj(A′)·X ⇒ conj-reduce below
             "C": "N"}[t]
        if t == "TU":
            # conj(A′)·X = B ⟺ A′·conj(X) = conj(B)
            xr, xi = _trsm_lower_left(ar, ai, br, -bi, "N",
                                      diag == Diag.UNIT, backend, block_size)
            return _merge(xr, -xi, B)

    xr, xi = _trsm_lower_left(ar, ai, br, bi, t, diag == Diag.UNIT,
                              backend, block_size)
    return _merge(xr, xi, B)
