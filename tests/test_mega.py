"""The diagonal-block leaf contract of the XLA tiles (ops/blocked.py
_XlaTiles.potf2/trti2/lauu2): the on-device factor/inverse of the
reference's spotf2/strti2 (reference lapack/spotrf.cu:26-107), at sizes
from a few rows to a whole mid-size matrix. Each leaf runs the library
solver and, when its result is not finite, the oracle sweep under
lax.cond — the failure cases below exercise that rescue. On the GPU the
same contract is checked at full size by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cholesky_tpu.ops import blocked
from cholesky_tpu.rng import generators
from tests.util import assert_close


def spd(n, cond=50.0, seed=0):
    return generators.latmc(jax.random.PRNGKey(seed), n, cond, jnp.float32)


TILES = blocked._XlaTiles(jnp.float32)


@pytest.mark.parametrize("n", [8, 64, 128, 256, 512])
def test_potrf_vmem(n):
    A = spd(n)
    L, info = TILES.potf2(A)
    assert int(info) == 0
    Ln = np.asarray(L, np.float64)
    # strict upper must be exactly zero
    assert np.all(np.triu(Ln, 1) == 0.0)
    An = np.asarray(A, np.float64)
    ref = np.linalg.cholesky(np.tril(An) + np.tril(An, -1).T)
    assert_close(Ln, ref, jnp.float32, 8 * n, f"potrf_vmem n={n}")


def test_potrf_vmem_only_lower_read():
    # the strict upper triangle of the input must never be read
    A = np.array(spd(256))
    A[np.triu_indices(256, 1)] = np.nan
    L, info = TILES.potf2(jnp.asarray(A))
    assert int(info) == 0
    assert np.isfinite(np.asarray(L)).all()


def test_potrf_vmem_nonpd_info_and_finite():
    # failed pivot: 1-based index, clamped to 1, everything stays finite
    A = np.array(spd(256, cond=10.0))
    A[4, 4] = -1.0
    L, info = TILES.potf2(jnp.asarray(A))
    assert int(info) == 5
    assert np.isfinite(np.asarray(L)).all()


def test_potrf_vmem_nan_pivot():
    # NaN pivot sets info (reference checks `aii <= zero || isnan(aii)`,
    # lapack/spotrf.c:47-51) and the rescue sweep freezes at it (reference
    # break semantics): the input NaN stays AT its own position, nothing
    # else becomes non-finite
    A = np.array(spd(256, cond=10.0))
    A[7, 7] = np.nan
    L, info = TILES.potf2(jnp.asarray(A))
    assert int(info) == 8
    Ln = np.asarray(L)
    bad = {tuple(ix) for ix in np.argwhere(~np.isfinite(Ln))}
    assert bad <= {(7, 7)}, bad


@pytest.mark.parametrize("n", [8, 64, 128, 256, 512])
def test_trtri_vmem(n):
    A = spd(n)
    F, _ = TILES.potf2(A)
    W, info = TILES.trti2(F)
    assert int(info) == 0
    Wn = np.asarray(W, np.float64)
    assert np.all(np.triu(Wn, 1) == 0.0)
    Fn = np.tril(np.asarray(F, np.float64))
    resid = np.max(np.abs(Wn @ Fn - np.eye(n)))
    # |W·F − I| ≤ fpe·eps·cond-ish; the factor of a cond-50 SPD matrix
    assert resid < 60 * n * np.finfo(np.float32).eps, resid


def test_trtri_vmem_zero_diag_info():
    # a zero diagonal entry sets info to its 1-based index (reference
    # xtrtri semantics, lapack/strtri.c:12-40) and output stays finite
    A = np.array(np.tril(np.asarray(spd(256))), np.float32)
    np.fill_diagonal(A, 1.0)
    A[9, 9] = 0.0
    W, info = TILES.trti2(jnp.asarray(A))
    assert int(info) == 10
    assert np.isfinite(np.asarray(W)).all()


@pytest.mark.parametrize("unit", [False, True])
def test_blocked_trti2_mega_unit(unit):
    # the unit-diag path through _XlaTiles.trti2 must preserve the
    # caller's diagonal and invert with implicit ones
    n = 256
    F = generators.random_triangular(jax.random.PRNGKey(3), n, "L",
                                     "U" if unit else "N", jnp.float32)
    W, info = TILES.trti2(F, unit=unit)
    assert int(info) == 0
    Fn = np.tril(np.asarray(F, np.float64))
    if unit:
        np.fill_diagonal(Fn, 1.0)
    ref = np.linalg.inv(Fn)
    Wn = np.asarray(W, np.float64)
    if unit:
        # diagonal passes through untouched
        np.testing.assert_array_equal(np.diag(np.asarray(W)),
                                      np.diag(np.asarray(F)))
        Wn = np.tril(Wn, -1) + np.eye(n)
    assert_close(np.tril(Wn), np.tril(ref), jnp.float32, 60 * n,
                 f"trti2 mega unit={unit}")


# --------------------------------------------------------------------------
# whole mid-size matrices through one leaf
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1280, pytest.param(2048, marks=pytest.mark.slow),
                               pytest.param(2560, marks=pytest.mark.slow)])
def test_potrf_hbm(n):
    A = spd(n)
    L, info = TILES.potf2(A)
    assert int(info) == 0
    Ln = np.asarray(L, np.float64)
    assert np.all(np.triu(Ln, 1) == 0.0)
    An = np.asarray(A, np.float64)
    ref = np.linalg.cholesky(np.tril(An) + np.tril(An, -1).T)
    assert_close(Ln, ref, jnp.float32, 8 * n, f"potrf_hbm n={n}")


def test_potrf_hbm_only_lower_read_and_freeze():
    n = 1280
    A = np.array(spd(n, cond=10.0))
    A[np.triu_indices(n, 1)] = np.nan       # upper must never be read
    A[700, 700] = -3.0                      # failed pivot mid-matrix
    L, info = TILES.potf2(jnp.asarray(A))
    assert int(info) == 701
    Ln = np.asarray(L)
    assert np.isfinite(Ln).all()
    # the leading (info-1) block is still the exact factor of A's leading
    # block (reference break semantics: work before the failure is kept)
    k = 700
    ref = np.linalg.cholesky(np.tril(A[:k, :k]).astype(np.float64)
                             + np.tril(A[:k, :k], -1).astype(np.float64).T)
    assert_close(np.asarray(Ln[:k, :k], np.float64), ref, jnp.float32,
                 8 * n, "potrf_hbm frozen leading block")


@pytest.mark.parametrize("n", [1280, pytest.param(2048, marks=pytest.mark.slow),
                               pytest.param(2560, marks=pytest.mark.slow)])
def test_trtri_hbm(n):
    F, _ = TILES.potf2(spd(n))     # factor: condition ~sqrt(cond)
    W, info = TILES.trti2(F)
    assert int(info) == 0
    Wn = np.asarray(W, np.float64)
    assert np.all(np.triu(Wn, 1) == 0.0)
    Fn = np.tril(np.asarray(F, np.float64))
    resid = np.max(np.abs(Wn @ Fn - np.eye(n)))
    assert resid < 60 * n * np.finfo(np.float32).eps, resid


@pytest.mark.parametrize("n", [256, 1280,
                               pytest.param(2048, marks=pytest.mark.slow)])
def test_lauum_hbm(n):
    F, _ = TILES.potf2(spd(n))
    P = TILES.lauu2(F)
    Pn = np.asarray(P, np.float64)
    assert np.all(np.triu(Pn, 1) == 0.0)
    Fn = np.tril(np.asarray(F, np.float64))
    ref = np.tril(Fn.T @ Fn)
    assert_close(Pn, ref, jnp.float32, 8 * n, f"lauum_hbm n={n}")


def test_lauum_hbm_only_lower_read():
    n = 256
    A = np.array(np.tril(np.asarray(spd(n))), np.float32)
    A[np.triu_indices(n, 1)] = np.nan
    P = TILES.lauu2(jnp.asarray(A))
    assert np.isfinite(np.asarray(P)).all()


def test_trtri_hbm_zero_diag_info():
    n = 1280
    A = np.array(np.tril(np.asarray(spd(n))), np.float32)
    np.fill_diagonal(A, 1.0)
    A[599, 599] = 0.0
    W, info = TILES.trti2(jnp.asarray(A))
    assert int(info) == 600
    assert np.isfinite(np.asarray(W)).all()
