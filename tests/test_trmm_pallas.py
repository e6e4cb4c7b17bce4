"""Live-block TRMM recursion (ops/blocked.py _trmm_lln_tiles) and its
16-combo canonicalization in blocked.trmm, on the f32 XLA tiles.
Reference bar: one hand-written kernel per side/uplo/trans combo
(reference blas/strmm.cu, ztrmm.cu:73-1005)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cholesky_tpu.ops import blocked
from tests.util import assert_close


def rnd(shape, seed=0):
    return (jax.random.uniform(jax.random.PRNGKey(seed), shape,
                               jnp.float32) - 0.5)


@pytest.mark.parametrize("n,m", [(8, 8), (128, 128), (256, 384),
                                 (200, 130), (384, 100)])
def test_trmm_lln_kernel(n, m):
    L = jnp.tril(rnd((n, n), 1))
    B = rnd((n, m), 2)
    # nb=64 makes every n > 96 split into live blocks
    C = 2.0 * blocked._trmm_lln_tiles(L, B, blocked._XlaTiles(jnp.float32),
                                      64)
    ref = 2.0 * np.tril(np.asarray(L, np.float64)) @ np.asarray(B, np.float64)
    assert_close(np.asarray(C), ref, jnp.float32, 2 * n + 3, "trmm_lln")


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_blocked_trmm_all_combos(side, uplo, trans, diag):
    n = 160          # not a tile multiple: exercises padding
    A = rnd((n, n), 3) + jnp.eye(n)
    B = rnd((n, n), 4)
    C = blocked.trmm(side, uplo, trans, diag, 1.5, A, B, backend="auto")
    An = np.asarray(A, np.float64)
    T = np.tril(An) if uplo == "L" else np.triu(An)
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    opA = T if trans == "N" else T.T
    Bn = np.asarray(B, np.float64)
    ref = 1.5 * (opA @ Bn if side == "L" else Bn @ opA)
    assert_close(np.asarray(C), ref, jnp.float32, 3 * n + 3,
                 f"trmm {side}{uplo}{trans}{diag}")


def test_blocked_trmm_reads_only_selected_triangle():
    # the dead triangle may hold garbage (even NaN) without affecting
    # the result: the live-block recursion reads only the triangle
    n = 256
    A = np.array(rnd((n, n), 5) + jnp.eye(n))
    A[np.triu_indices(n, 1)] = np.nan
    B = rnd((n, n), 6)
    C = blocked.trmm("L", "L", "N", "N", 1.0, jnp.asarray(A), B,
                     backend="auto")
    assert np.isfinite(np.asarray(C)).all()
