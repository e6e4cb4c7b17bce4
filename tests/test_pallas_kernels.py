"""f32 tile layer (ops/blocked.py _XlaTiles: mm, syrk, and the
potf2/trti2/lauu2 leaves) vs the oracle tier.

The analog of the reference's test/blas/cusgemm.c etc. — kernel vs naive
ref. On the GPU these tiles are cuBLAS GEMMs and cuSOLVER/cuBLAS leaves;
chip_smoke.py checks them there at full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cholesky_tpu.ops import blocked
from cholesky_tpu.rng import generators
from tests.util import assert_close, to_np128


T32 = blocked._XlaTiles(jnp.float32)


def rnd(seed, shape):
    return (jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float64)
            - 0.5).astype(jnp.float32)


@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 384, 512),
                                   (100, 50, 70), (512, 256, 1000)])
def test_matmul(m, n, k):
    A, B, C = rnd(0, (m, k)), rnd(1, (k, n)), rnd(2, (m, n))
    out = T32.mm(A, B, alpha=0.9, beta=-0.4, C=C)
    ref = 0.9 * to_np128(A) @ to_np128(B) - 0.4 * to_np128(C)
    assert_close(out, ref, jnp.float32, 2 * k + 3, "tile matmul")


def test_matmul_beta_zero():
    A, B = rnd(3, (256, 256)), rnd(4, (256, 256))
    out = T32.mm(A, B, alpha=1.0, beta=0.0)
    ref = to_np128(A) @ to_np128(B)
    assert_close(out, ref, jnp.float32, 2 * 256 + 3, "tile matmul beta=0")


@pytest.mark.parametrize("n,k", [(256, 256), (384, 512), (130, 100)])
def test_syrk(n, k):
    A, C = rnd(5, (n, k)), rnd(6, (n, n))
    out = blocked.syrk("L", "N", -1.0, A, 1.0, C)   # over T32.syrk_ln
    full = -to_np128(A) @ to_np128(A).T + to_np128(C)
    mask = np.tril(np.ones((n, n)))
    ref = np.where(mask > 0, full, to_np128(C))
    assert_close(out, ref, jnp.float32, 2 * k + 3, "tile syrk")
    # strict upper must be bit-identical to C
    np.testing.assert_array_equal(np.triu(np.asarray(out), 1),
                                  np.triu(np.asarray(C), 1))


@pytest.mark.parametrize("n", [128, 256])
def test_potf2_leaf(n):
    A = generators.latmc(jax.random.PRNGKey(7), n, 50.0, jnp.float32)
    L, info = T32.potf2(A)
    assert int(info) == 0
    ref = np.linalg.cholesky(to_np128(A))
    assert_close(np.asarray(L), ref, jnp.float32, 8 * n, "potf2 leaf")
    # strict upper zeroed by contract
    np.testing.assert_array_equal(np.triu(np.asarray(L), 1), 0)


def test_potf2_leaf_nonpd_info():
    A = np.asarray(generators.latmc(jax.random.PRNGKey(8), 128, 10.0,
                                    jnp.float32)).copy()
    A[40, 40] = -3.0
    L, info = T32.potf2(jnp.asarray(0.5 * (A + A.T), jnp.float32))
    assert 1 <= int(info) <= 41
    assert np.isfinite(np.asarray(L)).all()


def test_potf2_leaf_nan_pivot_sets_info():
    # NaN pivots must be flagged like non-positive ones (the reference
    # checks `aii <= zero || isnan(aii)`, spotrf.c:47-51)
    A = np.asarray(generators.latmc(jax.random.PRNGKey(9), 128, 10.0,
                                    jnp.float32)).copy()
    A[17, 17] = np.nan
    L, info = T32.potf2(jnp.asarray(A, jnp.float32))
    assert 1 <= int(info) <= 18


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("unit", [False, True])
def test_trti2_leaf(n, unit):
    A = generators.random_triangular(jax.random.PRNGKey(9), n, "L",
                                     "U" if unit else "N", jnp.float32)
    T, info = T32.trti2(A, unit=unit)
    assert int(info) == 0
    Anp = to_np128(A)
    if unit:
        np.fill_diagonal(Anp, 1.0)
    ref = np.linalg.inv(np.tril(Anp))
    got = np.asarray(T)
    if unit:
        # diagonal passes through untouched; compare strict lower
        assert_close(np.tril(got, -1), np.tril(ref, -1), jnp.float32,
                     40 * n, "trti2 unit")
        np.testing.assert_array_equal(np.diag(got), np.diag(np.asarray(A)))
    else:
        assert_close(np.tril(got), np.tril(ref), jnp.float32, 40 * n, "trti2")


def test_trti2_singular_info():
    A = np.asarray(generators.random_triangular(
        jax.random.PRNGKey(10), 128, "L", "N", jnp.float32)).copy()
    A[33, 33] = 0.0
    _, info = T32.trti2(jnp.asarray(A))
    assert int(info) == 34


@pytest.mark.parametrize("n", [128, 256])
def test_lauu2_leaf(n):
    A = generators.random_triangular(jax.random.PRNGKey(11), n, "L", "N",
                                     jnp.float32)
    out = T32.lauu2(A)
    L = np.tril(to_np128(A))
    ref_l = np.tril(L.T @ L)
    got = np.asarray(out)
    assert_close(np.tril(got), ref_l, jnp.float32, 2 * n + 3, "lauu2")
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(np.asarray(A), 1))
