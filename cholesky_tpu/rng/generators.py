"""RNG subsystem: threefry-based generators + condition-numbered test matrices.

Rebuild of the reference's rng/ layer (reference include/rng.h —
SFMT/dSFMT/MT19937/MTGP cores, declared but never wired into the build, see
SURVEY.md §1 L4) and of the test-matrix generators
(reference test/lapack/util/slatmc.c:11-70).

Design mapping:
- The Mersenne-family algorithms are replaced by JAX's counter-based
  threefry (jax.random) — splittable, reproducible, and generated on the
  device; the *contracts* are kept: seeded determinism, four uniform interval
  variants (reference rng.h:21-101), and SPD/HPD matrices with a prescribed
  2-norm condition number. jax.random's bulk on-device fills also play
  the role of the GPU MTGP kernels.
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

from cholesky_tpu import config

from cholesky_tpu.types import is_complex, real_dtype


class Interval(str, enum.Enum):
    """The four uniform-interval variants of the reference's rng.h
    (Get / GetOpen / GetHalfOpen01 / GetHalfOpen10, rng.h:21-101)."""
    CLOSED = "[0,1]"
    OPEN = "(0,1)"
    HALF_OPEN_01 = "[0,1)"
    HALF_OPEN_10 = "(0,1]"


def uniform(key, shape, dtype=jnp.float32, interval=Interval.HALF_OPEN_01):
    """Uniform floats with the requested interval semantics."""
    interval = Interval(interval)
    u = jax.random.uniform(key, shape, dtype=dtype)  # [0, 1)
    if interval == Interval.HALF_OPEN_01:
        return u
    eps = jnp.finfo(dtype).eps
    if interval == Interval.HALF_OPEN_10:
        return 1.0 - u                                # (0, 1]
    if interval == Interval.CLOSED:
        return u / (1.0 - eps)                        # [0, 1]
    # OPEN: shift off both endpoints
    return u * (1.0 - eps) + eps                      # (0, 1)


def _householder_apply(V, A, side_left: bool):
    """Apply the product of Householder reflections H(v) = I - 2 v vᴴ for the
    unit columns v of V to A (left: H A, right: A H), without materializing H.
    """
    for i in range(V.shape[1]):
        v = V[:, i:i + 1]
        if side_left:
            A = A - 2.0 * jnp.matmul(v, jnp.matmul(v.conj().T, A, precision=config.matmul_precision), precision=config.matmul_precision)
        else:
            A = A - 2.0 * jnp.matmul(jnp.matmul(A, v, precision=config.matmul_precision), v.conj().T, precision=config.matmul_precision)
    return A


def latmc(key, n, cond=2.0, dtype=jnp.float32, rank_correction: int = 2):
    """Random SPD (HPD for complex dtypes) n×n matrix with exact 2-norm
    condition number ``cond``.

    Rebuild of the reference's xlatmc generators (test/lapack/util/
    slatmc.c:11-70): eigenvalues spread over [1, cond], made dense by a
    similarity with a product of ``rank_correction`` random Householder
    reflections (the reference uses a rank-2 symmetric correction).
    Deterministic under the given key (the reference seeds srand(0),
    test/lapack/cuspotrf.c:49).
    """
    rdt = real_dtype(dtype)
    kd, kv, kp = jax.random.split(key, 3)
    # eigenvalues linearly spaced in [1, cond] — exact condition number
    lam = jnp.linspace(jnp.asarray(1.0, rdt), jnp.asarray(cond, rdt), n)
    if is_complex(dtype):
        vr = jax.random.normal(kv, (n, rank_correction), rdt)
        vi = jax.random.normal(kp, (n, rank_correction), rdt)
        # lax.complex keeps the target width — `vr + 1j*vi` would promote
        # to complex128 under x64
        V = jax.lax.complex(vr, vi).astype(dtype)
    else:
        V = jax.random.normal(kv, (n, rank_correction), rdt).astype(dtype)
    V = V / jnp.linalg.norm(V, axis=0, keepdims=True)
    # A = Q diag(lam) Qᴴ with Q = H(v₁)···H(v_r): exactly Hermitian PD.
    D = jnp.diag(lam.astype(dtype))
    A = _householder_apply(V, D, side_left=False)     # D Qᴴ... build as Q D Qᴴ
    A = _householder_apply(V, A, side_left=True)
    # Symmetrize against rounding so potrf sees an exactly Hermitian input.
    A = 0.5 * (A + A.conj().T)
    if is_complex(dtype):
        dimag = jnp.diag(jnp.diag(A).imag)
        A = A - jax.lax.complex(jnp.zeros_like(dimag), dimag).astype(dtype)
    return A


def latmc_pair(key, n, cond=2.0, rdtype=jnp.float32, rank_correction: int = 2):
    """``latmc`` for complex dtypes carried as an (re, im) PAIR of real
    planes — never materializes a complex array (the pair form is the
    entry for the embedding tier, ops/complex_embed.py).
    Same construction and exact-cond contract as :func:`latmc`."""
    rdt = jnp.dtype(rdtype)
    kd, kv, kp = jax.random.split(key, 3)
    lam = jnp.linspace(jnp.asarray(1.0, rdt), jnp.asarray(cond, rdt), n)
    vr = jax.random.normal(kv, (n, rank_correction), rdt)
    vi = jax.random.normal(kp, (n, rank_correction), rdt)
    nrm = jnp.sqrt(jnp.sum(vr * vr + vi * vi, axis=0, keepdims=True))
    vr, vi = vr / nrm, vi / nrm
    p = config.matmul_precision

    def pmm(ar, ai, br, bi):
        """(ar+i·ai)(br+i·bi) as 4 real matmuls."""
        return (jnp.matmul(ar, br, precision=p) - jnp.matmul(ai, bi, precision=p),
                jnp.matmul(ar, bi, precision=p) + jnp.matmul(ai, br, precision=p))

    def happly(ar, ai, left):
        for i in range(rank_correction):
            cr, ci = vr[:, i:i + 1], vi[:, i:i + 1]
            if left:            # A − 2 v (vᴴ A)
                wr, wi = pmm(cr.T, -ci.T, ar, ai)
                ur, ui = pmm(cr, ci, wr, wi)
            else:               # A − 2 (A v) vᴴ
                wr, wi = pmm(ar, ai, cr, ci)
                ur, ui = pmm(wr, wi, cr.T, -ci.T)
            ar, ai = ar - 2.0 * ur, ai - 2.0 * ui
        return ar, ai

    Ar, Ai = jnp.diag(lam), jnp.zeros((n, n), rdt)
    Ar, Ai = happly(Ar, Ai, left=False)
    Ar, Ai = happly(Ar, Ai, left=True)
    # exactly Hermitian: re symmetric, im skew with zero diagonal
    Ar = 0.5 * (Ar + Ar.T)
    Ai = 0.5 * (Ai - Ai.T)
    Ai = Ai - jnp.diag(jnp.diag(Ai))
    return Ar, Ai


def random_triangular(key, n, uplo="L", diag="N", dtype=jnp.float32,
                      well_conditioned=True):
    """Random triangular matrix for trtri/trsm/trmm tests; with
    ``well_conditioned`` the diagonal is pushed away from zero (dominant),
    keeping inverse tests numerically meaningful."""
    from cholesky_tpu.types import Uplo, Diag, norm_uplo, norm_diag
    uplo = norm_uplo(uplo)
    diag = norm_diag(diag)
    rdt = real_dtype(dtype)
    k1, k2 = jax.random.split(key)
    if is_complex(dtype):
        # lax.complex keeps the target width — `re + 1j*im` promotes to
        # complex128 under x64
        A = jax.lax.complex(jax.random.uniform(k1, (n, n), rdt) - 0.5,
                            jax.random.uniform(k2, (n, n), rdt) - 0.5
                            ).astype(dtype)
    else:
        A = (jax.random.uniform(k1, (n, n), rdt) - 0.5).astype(dtype)
    if well_conditioned:
        d = jnp.diag(A)
        mag = jnp.abs(d) + 1.0
        scale = (mag / jnp.where(jnp.abs(d) == 0, 1.0, jnp.abs(d)))
        newd = jnp.where(jnp.abs(d) == 0, mag.astype(dtype), d * scale.astype(dtype))
        A = A - jnp.diag(d) + jnp.diag(newd)
    A = jnp.tril(A) if uplo == Uplo.LOWER else jnp.triu(A)
    if diag == Diag.UNIT:
        A = A - jnp.diag(jnp.diag(A)) + jnp.eye(n, dtype=dtype)
    return A
