"""Blocked recursive drivers vs numpy oracles.

The analog of the reference's test/lapack/cu*.c single-GPU-tier tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cholesky_tpu.ops import blocked
from cholesky_tpu.rng import generators
from tests.util import ALL_DTYPES, assert_close, to_np128

N = 200  # deliberately not a block-size multiple — exercises identity padding
NB = 64


def spd(n, dtype, cond=50.0, seed=0):
    return generators.latmc(jax.random.PRNGKey(seed), n, cond, dtype)


BACKENDS = [("xla", ALL_DTYPES)]
CASES = [(b, dt) for b, dts in BACKENDS for dt in dts]


@pytest.mark.parametrize("backend,dtype", CASES)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_blocked(backend, dtype, uplo):
    A = spd(N, dtype)
    F, info = blocked.potrf(uplo, A, backend=backend, block_size=NB)
    assert int(info) == 0
    L = np.linalg.cholesky(to_np128(A))
    ref = L if uplo == "L" else L.conj().T
    tri = np.tril if uplo == "L" else np.triu
    assert_close(tri(np.asarray(F)), tri(ref), dtype, 8 * N,
                 f"potrf {backend} {uplo}")
    # opposite strict triangle untouched
    anti = np.triu(np.asarray(F), 1) if uplo == "L" else np.tril(np.asarray(F), -1)
    anti_in = np.triu(np.asarray(A), 1) if uplo == "L" else np.tril(np.asarray(A), -1)
    np.testing.assert_array_equal(anti, anti_in)


@pytest.mark.parametrize("backend,dtype", CASES)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_blocked_nonpd(backend, dtype, uplo):
    A = np.asarray(spd(N, dtype, cond=10.0)).copy()
    A[77, 77] = -4.0
    A = jnp.asarray(0.5 * (A + A.conj().T))
    F, info = blocked.potrf(uplo, A, backend=backend, block_size=NB)
    _, ref_info = blocked.potrf(uplo, A, backend="ref")
    assert 1 <= int(info) <= 78
    assert np.isfinite(np.asarray(F)).all() if not np.iscomplexobj(
        np.asarray(F)) else np.isfinite(np.abs(np.asarray(F))).all()


@pytest.mark.parametrize("backend,dtype", CASES)
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_trtri_blocked(backend, dtype, uplo, diag):
    A = generators.random_triangular(jax.random.PRNGKey(3), N, uplo, diag,
                                     dtype)
    R, info = blocked.trtri(uplo, diag, A, backend=backend, block_size=NB)
    assert int(info) == 0
    T = to_np128(A)
    T = np.tril(T) if uplo == "L" else np.triu(T)
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    ref = np.linalg.inv(T)
    got = np.asarray(R)
    if diag == "U":
        s = np.tril(got, -1) if uplo == "L" else np.triu(got, 1)
        r = np.tril(ref, -1) if uplo == "L" else np.triu(ref, 1)
        assert_close(s, r, dtype, 60 * N, f"trtri {backend} {uplo}{diag}")
        np.testing.assert_array_equal(np.diag(got), np.diag(np.asarray(A)))
    else:
        tri = np.tril if uplo == "L" else np.triu
        assert_close(tri(got), tri(ref), dtype, 60 * N,
                     f"trtri {backend} {uplo}{diag}")


@pytest.mark.parametrize("backend,dtype", CASES)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_lauum_blocked(backend, dtype, uplo):
    A = generators.random_triangular(jax.random.PRNGKey(4), N, uplo, "N",
                                     dtype)
    out = blocked.lauum(uplo, A, backend=backend, block_size=NB)
    T = to_np128(A)
    if uplo == "U":
        T = np.triu(T)
        ref = T @ T.conj().T
        tri = np.triu
    else:
        T = np.tril(T)
        ref = T.conj().T @ T
        tri = np.tril
    assert_close(tri(np.asarray(out)), tri(ref), dtype, 2 * N + 3,
                 f"lauum {backend} {uplo}")


@pytest.mark.parametrize("backend,dtype", CASES)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potri_blocked(backend, dtype, uplo):
    A = spd(N, dtype, cond=30.0, seed=5)
    F, _ = blocked.potrf(uplo, A, backend=backend, block_size=NB)
    Inv, info = blocked.potri(uplo, F, backend=backend, block_size=NB)
    assert int(info) == 0
    ref = np.linalg.inv(to_np128(A))
    tri = np.tril if uplo == "L" else np.triu
    assert_close(tri(np.asarray(Inv)), tri(ref), dtype, 3000 * N,
                 f"potri {backend} {uplo}")


@pytest.mark.parametrize("backend,dtype", CASES)
def test_logdet_blocked(backend, dtype):
    A = spd(N, dtype, cond=20.0, seed=6)
    val, info = blocked.logdet("L", A, backend=backend, block_size=NB)
    assert int(info) == 0
    _, ref = np.linalg.slogdet(to_np128(A))
    assert_close(np.asarray(val), np.asarray(ref), dtype, 60 * N,
                 f"logdet {backend}")


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_trsm_blocked_pallas(side, uplo, trans, diag):
    dtype = jnp.float32
    na = N if side == "L" else 96
    m, n = (N, 96) if side == "L" else (N, 96)
    A = generators.random_triangular(jax.random.PRNGKey(7), na, uplo, diag,
                                     dtype)
    B = (jax.random.uniform(jax.random.PRNGKey(8), (m, n), jnp.float64)
         - 0.5).astype(dtype)
    out = blocked.trsm(side, uplo, trans, diag, 0.9, A, B,
                       backend="auto", block_size=NB)
    T = to_np128(A)
    T = np.tril(T) if uplo == "L" else np.triu(T)
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    T = T if trans == "N" else T.T
    if side == "L":
        ref = np.linalg.solve(T, 0.9 * to_np128(B))
    else:
        ref = np.linalg.solve(T.T, 0.9 * to_np128(B).T).T
    assert_close(np.asarray(out), ref, dtype, 60 * na,
                 f"trsm auto {side}{uplo}{trans}{diag}")


@pytest.mark.parametrize("ta", ["N", "T"])
@pytest.mark.parametrize("tb", ["N", "T"])
def test_gemm_blocked_pallas(ta, tb):
    m, n, k = 96, 80, 112
    A = (jax.random.uniform(jax.random.PRNGKey(9),
                            (m, k) if ta == "N" else (k, m), jnp.float64)
         - 0.5).astype(jnp.float32)
    B = (jax.random.uniform(jax.random.PRNGKey(10),
                            (k, n) if tb == "N" else (n, k), jnp.float64)
         - 0.5).astype(jnp.float32)
    C = (jax.random.uniform(jax.random.PRNGKey(11), (m, n), jnp.float64)
         - 0.5).astype(jnp.float32)
    out = blocked.gemm(ta, tb, 0.7, A, B, -0.2, C, backend="auto")
    An, Bn = to_np128(A), to_np128(B)
    An = An if ta == "N" else An.T
    Bn = Bn if tb == "N" else Bn.T
    ref = 0.7 * An @ Bn - 0.2 * to_np128(C)
    assert_close(out, ref, jnp.float32, 2 * k + 3, f"gemm auto {ta}{tb}")


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
def test_syrk_blocked_pallas(uplo, trans):
    n, k = 112, 96
    A = (jax.random.uniform(jax.random.PRNGKey(12),
                            (n, k) if trans == "N" else (k, n), jnp.float64)
         - 0.5).astype(jnp.float32)
    C = (jax.random.uniform(jax.random.PRNGKey(13), (n, n), jnp.float64)
         - 0.5).astype(jnp.float32)
    out = blocked.syrk(uplo, trans, -1.0, A, 1.0, C, backend="auto")
    An = to_np128(A)
    An = An if trans == "N" else An.T
    full = -An @ An.T + to_np128(C)
    mask = np.tril(np.ones((n, n))) if uplo == "L" else np.triu(np.ones((n, n)))
    ref = np.where(mask > 0, full, to_np128(C))
    assert_close(out, ref, jnp.float32, 2 * k + 3, f"syrk auto {uplo}{trans}")
    # other strict triangle preserved exactly
    anti = np.triu(np.asarray(out), 1) if uplo == "L" else np.tril(np.asarray(out), -1)
    anti_c = np.triu(np.asarray(C), 1) if uplo == "L" else np.tril(np.asarray(C), -1)
    np.testing.assert_array_equal(anti, anti_c)


def test_potrf_no_method_knob():
    # there is no invert-as-you-go method knob (the diagonal-inverse
    # trick lives at the leaves and in the dist tier) — passing one must
    # fail loudly
    A = spd(N, jnp.float32, seed=11)
    with pytest.raises(TypeError):
        blocked.potrf("L", A, method="inverse")
