"""Complex routines via the interleaved real embedding vs numpy oracles.

This path (backend='embed', or (re, im) pair operands) runs c/z routines
on the real f32/f64 tiles — the structural analog of the reference's split
re/im shared-memory storage (cgemm.cu:7-15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cholesky_tpu.ops import complex_embed as ce
from cholesky_tpu.rng import generators, latmc
from tests.util import assert_close, to_np128

N = 96


def hpd(dtype, seed=0, cond=40.0):
    return latmc(jax.random.PRNGKey(seed), N, cond, dtype)


def test_embed_roundtrip_and_homomorphism():
    A = hpd(jnp.complex64)
    B = hpd(jnp.complex64, seed=1)
    re, im = np.asarray(A.real), np.asarray(A.imag)
    M = np.asarray(ce.embed(A.real, A.imag))
    r2, i2 = (np.asarray(x) for x in ce.unembed(jnp.asarray(M)))
    np.testing.assert_array_equal(re, r2)
    np.testing.assert_array_equal(im, i2)
    # E(A·B) == E(A)·E(B)
    MAB = np.asarray(ce.embed((A @ B).real, (A @ B).imag), np.float64)
    ME = np.asarray(ce.embed(A.real, A.imag), np.float64) @ \
        np.asarray(ce.embed(B.real, B.imag), np.float64)
    assert np.max(np.abs(MAB - ME)) < 1e-3


@pytest.mark.parametrize("dtype", [jnp.complex64, jnp.complex128])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_split(dtype, uplo):
    A = hpd(dtype)
    F, info = ce.potrf_split(uplo, A, backend="xla", block_size=32)
    assert int(info) == 0
    L = np.linalg.cholesky(to_np128(A))
    ref = L if uplo == "L" else L.conj().T
    tri = np.tril if uplo == "L" else np.triu
    assert_close(tri(np.asarray(F)), tri(ref), dtype, 16 * N,
                 f"potrf_split {uplo}")


def test_potrf_split_pair_form():
    # the pair form for c128: operands as (re, im) real pairs
    A = hpd(jnp.complex128, seed=2)
    (fr, fi), info = ce.potrf_split("L", (A.real, A.imag), backend="xla",
                                    block_size=32)
    assert int(info) == 0
    ref = np.linalg.cholesky(np.asarray(A))
    got = np.tril(np.asarray(fr) + 1j * np.asarray(fi))
    assert np.max(np.abs(got - np.tril(ref))) < 1e-12


def test_potrf_split_nonpd_info():
    A = np.asarray(hpd(jnp.complex64, seed=3)).copy()
    A[50, 50] = -3.0
    A = jnp.asarray(0.5 * (A + A.conj().T))
    _, info = ce.potrf_split("L", A, backend="xla", block_size=32)
    assert 1 <= int(info) <= 51   # complex pivot index, not the embedded one


@pytest.mark.parametrize("dtype", [jnp.complex64, jnp.complex128])
def test_trtri_split(dtype):
    L = generators.random_triangular(jax.random.PRNGKey(4), N, "L", "N",
                                     dtype)
    W, info = ce.trtri_split("L", "N", L, backend="xla", block_size=32)
    assert int(info) == 0
    ref = np.linalg.inv(np.tril(to_np128(L)))
    assert_close(np.tril(np.asarray(W)), np.tril(ref), dtype, 80 * N,
                 "trtri_split")


@pytest.mark.parametrize("dtype", [jnp.complex64,
                                   pytest.param(jnp.complex128, marks=pytest.mark.slow)])
def test_potri_logdet_split(dtype):
    A = hpd(dtype, seed=5, cond=20.0)
    F, _ = ce.potrf_split("L", A, backend="xla", block_size=32)
    Inv, info = ce.potri_split("L", F, backend="xla", block_size=32)
    assert int(info) == 0
    ref = np.linalg.inv(to_np128(A))
    assert_close(np.tril(np.asarray(Inv)), np.tril(ref), dtype, 4000 * N,
                 "potri_split")
    val, info2 = ce.logdet_split("L", A, backend="xla", block_size=32)
    _, refld = np.linalg.slogdet(to_np128(A))
    assert_close(np.asarray(val), np.asarray(refld), dtype, 80 * N,
                 "logdet_split")


@pytest.mark.parametrize("dtype", [jnp.complex64, jnp.complex128])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
def test_trsm_split(dtype, trans):
    L = generators.random_triangular(jax.random.PRNGKey(6), N, "L", "N",
                                     dtype)
    B = (jax.random.normal(jax.random.PRNGKey(7), (N, 8))
         + 1j * jax.random.normal(jax.random.PRNGKey(8), (N, 8))
         ).astype(dtype)
    X = ce.trsm_split("L", "L", trans, "N", 1.0, L, B, backend="xla",
                      block_size=32)
    T = np.tril(to_np128(L))
    T = {"N": T, "T": T.T, "C": T.conj().T}[trans]
    ref = np.linalg.solve(T, to_np128(B))
    assert_close(np.asarray(X), ref, dtype, 100 * N, f"trsm_split {trans}")


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_trsm_split_all_combos(side, uplo, trans, diag):
    dtype = jnp.complex64
    na = 64
    A = generators.random_triangular(jax.random.PRNGKey(9), na, uplo, diag,
                                     dtype)
    m, n = (na, 24) if side == "L" else (24, na)
    B = (jax.random.normal(jax.random.PRNGKey(10), (m, n))
         + 1j * jax.random.normal(jax.random.PRNGKey(11), (m, n))
         ).astype(dtype)
    X = ce.trsm_split(side, uplo, trans, diag, 0.9, A, B, backend="xla",
                      block_size=16)
    T = to_np128(A)
    T = np.tril(T) if uplo == "L" else np.triu(T)
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    T = {"N": T, "T": T.T, "C": T.conj().T}[trans]
    if side == "L":
        ref = np.linalg.solve(T, 0.9 * to_np128(B))
    else:
        ref = np.linalg.solve(T.T, 0.9 * to_np128(B).T).T
    assert_close(np.asarray(X), ref, dtype, 150 * na,
                 f"trsm_split {side}{uplo}{trans}{diag}")


def test_potrf_split_ozaki_backend():
    # z-tier synthesis: complex128 → real embedding → f64 → Ozaki int8
    A = hpd(jnp.complex128, seed=12, cond=30.0)
    (fr, fi), info = ce.potrf_split("L", (A.real, A.imag), backend="ozaki",
                                    block_size=64)
    assert int(info) == 0
    ref = np.linalg.cholesky(np.asarray(A))
    got = np.tril(np.asarray(fr) + 1j * np.asarray(fi))
    assert np.max(np.abs(got - np.tril(ref))) < 1e-8


def test_potri_split_ozaki_backend():
    A = hpd(jnp.complex128, seed=13, cond=20.0)
    F, _ = ce.potrf_split("L", A, backend="ozaki", block_size=64)
    Inv, info = ce.potri_split("L", F, backend="ozaki", block_size=64)
    assert int(info) == 0
    ref = np.linalg.inv(np.asarray(A))
    assert np.max(np.abs(np.tril(np.asarray(Inv)) - np.tril(ref))) < 1e-6
