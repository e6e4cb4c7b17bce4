"""Ozaki int8-slice f64 matmul + d-precision drivers over it.

The f64-emulation subsystem (SURVEY.md §7 hard part #2): the successor of
the reference's hi/lo-int shared-memory double storage (dgemm.cu:3-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cholesky_tpu.ops import blocked
from cholesky_tpu.ops.ozaki import matmul_f64, K_EXACT_MAX
from cholesky_tpu.rng import latmc, generators


def rnd(seed, shape, spread=False):
    r = np.random.RandomState(seed)
    x = r.randn(*shape)
    if spread:
        x = x * np.exp(2.0 * r.randn(*shape))   # wide dynamic range
    return jnp.asarray(x)


@pytest.fixture(params=[64, 128], ids=["nb64", "nb128"])
def nb(request):
    """Leaf width of the Ozaki recursions: 64 splits the 200-row operands
    into four uneven leaves, 128 pads them to two equal ones — both shapes
    of the shared-peel indexing."""
    return request.param


@pytest.mark.parametrize("k", [64, 300, 1024])
@pytest.mark.parametrize("spread", [False, True])
def test_matmul_f64_accuracy(k, spread):
    A = rnd(0, (160, k), spread)
    B = rnd(1, (k, 120), spread)
    ref = np.asarray(A) @ np.asarray(B)
    for S, bound in [(4, 3e-6), (6, 1e-9)]:
        C = matmul_f64(A, B, slices=S)
        rel = np.max(np.abs(np.asarray(C) - ref)) / np.max(np.abs(ref))
        assert rel < bound, (S, rel)


def test_matmul_f64_exact_small_ints():
    # integer-valued inputs within slice range reproduce exactly
    A = jnp.asarray(np.random.RandomState(2).randint(-50, 50, (64, 64)),
                    jnp.float64)
    B = jnp.asarray(np.random.RandomState(3).randint(-50, 50, (64, 64)),
                    jnp.float64)
    C = matmul_f64(A, B, slices=4)
    np.testing.assert_array_equal(np.asarray(C),
                                  np.asarray(A) @ np.asarray(B))


def test_k_beyond_exact_bound_chunks():
    # K beyond the int32-exact bound splits the contraction into exact
    # chunks instead of failing at trace time (round-1 hard-asserted)
    k = K_EXACT_MAX + 128
    rs = np.random.RandomState(7)
    A = jnp.asarray(rs.uniform(-1, 1, (4, k)), jnp.float64)
    B = jnp.asarray(rs.uniform(-1, 1, (k, 4)), jnp.float64)
    C = matmul_f64(A, B, slices=6)
    ref = np.asarray(A) @ np.asarray(B)
    np.testing.assert_allclose(np.asarray(C), ref, rtol=0,
                               atol=k * 2.0 ** -40)


def test_dpotrf_f64_boundary_rescue():
    """Non-PD detection in the Ozaki leaves is an f64 verdict: the f32
    leaf flags borderline pivots, and a flagged
    leaf is re-factored by the true-f64 reference potf2 under lax.cond
    (ops/blocked.py _OzakiTiles.potf2).  A matrix PD in f64 but losing
    definiteness under f32 rounding therefore factors with info=0 —
    matching reference dpotrf (reference lapack/dpotrf.c) — while a truly
    non-PD matrix still reports the correct 1-based f64 pivot.
    """
    # [[1, a], [a, a² + δ]]: det = δ = 1e-12 > 0 (PD in f64), but in f32
    # a² + δ rounds back to a² ⇒ pivot 2 is 0 at f32 ⇒ f64 rescue fires.
    a, delta = 0.5, 1e-12
    A = jnp.asarray([[1.0, a], [a, a * a + delta]], jnp.float64)
    from cholesky_tpu.ops import lapack_ref
    _, info_ref = lapack_ref.potf2("L", A)
    assert int(info_ref) == 0
    F, info_oz = blocked.potrf("L", A, backend="ozaki")
    assert int(info_oz) == 0
    L = np.tril(np.asarray(F))
    assert np.max(np.abs(L @ L.T - np.asarray(A))) < 1e-15

    # truly non-PD: the same rescue path must CONFIRM the failure with the
    # correct f64 pivot index, and outputs stay finite (freeze semantics)
    B = jnp.asarray([[1.0, a], [a, a * a - 1e-6]], jnp.float64)
    FB, info_b = blocked.potrf("L", B, backend="ozaki")
    assert int(info_b) == 2
    assert np.all(np.isfinite(np.asarray(FB)))


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_dpotrf_ozaki(uplo):
    A = latmc(jax.random.PRNGKey(0), 200, 100.0, jnp.float64)
    F, info = blocked.potrf(uplo, A, backend="ozaki", block_size=64)
    assert int(info) == 0
    L = np.linalg.cholesky(np.asarray(A))
    ref = L if uplo == "L" else L.T
    tri = np.tril if uplo == "L" else np.triu
    err = np.max(np.abs(tri(np.asarray(F)) - tri(ref)))
    assert err < 1e-9, err   # slices=6 ⇒ far below the 1e-6 target


def test_dpotri_dlogdet_ozaki():
    A = latmc(jax.random.PRNGKey(1), 192, 30.0, jnp.float64)
    F, _ = blocked.potrf("L", A, backend="ozaki", block_size=64)
    Inv, info = blocked.potri("L", F, backend="ozaki", block_size=64)
    assert int(info) == 0
    ref = np.linalg.inv(np.asarray(A))
    assert np.max(np.abs(np.tril(np.asarray(Inv)) - np.tril(ref))) < 1e-7
    val, _ = blocked.logdet("L", A, backend="ozaki", block_size=64)
    _, refld = np.linalg.slogdet(np.asarray(A))
    assert abs(float(val) - refld) < 1e-9 * abs(refld) + 1e-9


def test_dtrtri_ozaki():
    L = generators.random_triangular(jax.random.PRNGKey(2), 200, "L", "N",
                                     jnp.float64)
    W, info = blocked.trtri("L", "N", L, backend="ozaki", block_size=64)
    assert int(info) == 0
    ref = np.linalg.inv(np.tril(np.asarray(L)))
    rel = np.max(np.abs(np.tril(np.asarray(W)) - np.tril(ref))) / \
        np.max(np.abs(ref))
    assert rel < 1e-8, rel


def test_dtrsm_ozaki_backend():
    # f64 trsm routes through the recursive driver with Ozaki tiles
    L = generators.random_triangular(jax.random.PRNGKey(5), 200, "L", "N",
                                     jnp.float64)
    B = jnp.asarray(np.random.RandomState(6).randn(200, 16))
    X = blocked.trsm("L", "L", "N", "N", 1.0, L, B, backend="ozaki",
                     block_size=64)
    ref = np.linalg.solve(np.tril(np.asarray(L)), np.asarray(B))
    scaled = np.max(np.abs(np.asarray(X) - ref)) / np.max(np.abs(ref))
    assert scaled < 1e-8, scaled


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_dtrtri_ozaki_hoisted_variants(uplo, diag, nb):
    # trtri routes through _OzakiTiles.trtri_lower (hoisted shared peel
    # of Lᵀ): cover upper + unit canonicalizations
    T = generators.random_triangular(jax.random.PRNGKey(9), 200, uplo, diag,
                                     jnp.float64)
    W, info = blocked.trtri(uplo, diag, T, backend="ozaki", block_size=nb)
    assert int(info) == 0
    tri = np.tril if uplo == "L" else np.triu
    M = tri(np.asarray(T))
    if diag == "U":
        np.fill_diagonal(M, 1.0)
    ref = np.linalg.inv(M)
    if diag == "U":
        # contract: unit-diagonal entries pass through untouched
        np.fill_diagonal(ref, np.diag(np.asarray(T)))
    rel = np.max(np.abs(tri(np.asarray(W)) - tri(ref))) / \
        np.max(np.abs(ref))
    assert rel < 1e-8, rel


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_dtrsm_ozaki_all_combos(side, uplo, trans, diag, nb):
    # the 16 canonicalized combos all land on the hoisted-peel
    # _OzakiTiles.trsm_lln / trsm_llt recursions; reference
    # per-combination kernels blas/dtrsm.cu
    na = 200 if side == "L" else 96
    T = generators.random_triangular(jax.random.PRNGKey(3), na, uplo, diag,
                                     jnp.float64)
    B = jnp.asarray(np.random.RandomState(4).randn(200, 96))
    X = blocked.trsm(side, uplo, trans, diag, 0.9, T, B,
                     backend="ozaki", block_size=nb)
    M = np.tril(np.asarray(T)) if uplo == "L" else np.triu(np.asarray(T))
    if diag == "U":
        np.fill_diagonal(M, 1.0)
    M = M if trans == "N" else M.T
    if side == "L":
        ref = np.linalg.solve(M, 0.9 * np.asarray(B))
    else:
        ref = np.linalg.solve(M.T, 0.9 * np.asarray(B).T).T
    rel = np.max(np.abs(np.asarray(X) - ref)) / np.max(np.abs(ref))
    assert rel < 1e-8, (side, uplo, trans, diag, rel)


def test_dsyrk_ozaki_single_peel(nb):
    # public syrk on the Ozaki tiles goes through syrk_ln (one peel for
    # both sides); verify against the numpy product at two widths
    A = jnp.asarray(np.random.RandomState(7).randn(200, nb))
    C = jnp.asarray(np.random.RandomState(8).randn(200, 200))
    out = blocked.syrk("L", "N", 0.5, A, -1.0, C, backend="ozaki")
    ref = 0.5 * (np.asarray(A) @ np.asarray(A).T) - np.asarray(C)
    got = np.tril(np.asarray(out))
    assert np.max(np.abs(got - np.tril(ref))) < 1e-10 * np.max(np.abs(ref))
    # strict upper passes through
    np.testing.assert_array_equal(np.triu(np.asarray(out), 1),
                                  np.triu(np.asarray(C), 1))


def test_dgemm_ozaki_backend():
    A = jnp.asarray(np.random.RandomState(7).randn(100, 80))
    B = jnp.asarray(np.random.RandomState(8).randn(80, 60))
    C = jnp.asarray(np.random.RandomState(9).randn(100, 60))
    out = blocked.gemm("N", "N", 0.5, A, B, -1.0, C, backend="ozaki")
    ref = 0.5 * np.asarray(A) @ np.asarray(B) - np.asarray(C)
    assert np.max(np.abs(np.asarray(out) - ref)) < 1e-9


@pytest.mark.parametrize("scaling", ["rows", "decay"])
def test_dtrmm_ozaki_bad_row_scaling(scaling, monkeypatch):
    """Pin live-block trmm accuracy under adversarial scalings: trmm_lln
    hoists ONE row-scale from the full row of L for every
    sub-block, so dropped-pair truncation is relative to the row max, not
    the block max.  Two stress cases: (a) per-row scales spanning 10^±8
    (captured exactly by the per-row split) and (b) within-row decay of
    10^8 away from the diagonal — the case where off-diagonal blocks are
    tiny relative to their row max.  Measured 2026-08-18 at slices=6:
    row-wise relative error ≤ 1.7e-11 in both; pinned at 1e-9 — if a
    future peel change reduces the slices=6 margin below this, fall back
    to per-block peeling."""
    monkeypatch.setattr(blocked, "TRMM_TILES_NB", 64)
    n = 256
    r = np.random.RandomState(0)
    if scaling == "rows":
        scale = (10.0 ** r.uniform(-8, 8, size=n))[:, None]
    else:
        i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        scale = 10.0 ** (-8.0 * np.clip(i - j, 0, None) / n)
    L = np.tril(r.randn(n, n)) * scale
    B = r.randn(n, 24)
    out = blocked.trmm("L", "L", "N", "N", 1.0, jnp.asarray(L),
                       jnp.asarray(B), backend="ozaki")
    ref = np.tril(L) @ B
    rowwise = np.max(np.max(np.abs(np.asarray(out) - ref), axis=1) /
                     (np.max(np.abs(ref), axis=1) + 1e-300))
    assert rowwise < 1e-9, rowwise


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("transa", ["N", "T"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_dtrmm_ozaki_live_blocks(side, uplo, transa, diag, monkeypatch):
    """f64 trmm over the live-block tile recursion: force a small leaf so the recursion actually splits, all 16 real combos."""
    monkeypatch.setattr(blocked, "TRMM_TILES_NB", 64)
    n = 200
    r = np.random.RandomState(hash((side, uplo, transa, diag)) % 2**31)
    A = jnp.asarray(r.randn(n, n))
    B = jnp.asarray(r.randn(n, 24) if side == "L" else r.randn(24, n))
    out = blocked.trmm(side, uplo, transa, diag, 0.5, A, B, backend="ozaki")
    T = np.tril(np.asarray(A)) if uplo == "L" else np.triu(np.asarray(A))
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    if transa == "T":
        T = T.T
    ref = 0.5 * (T @ np.asarray(B) if side == "L" else np.asarray(B) @ T)
    scaled = np.max(np.abs(np.asarray(out) - ref)) / np.max(np.abs(ref))
    assert scaled < 1e-8, scaled


def test_dpotrf_inverse_leaf_refinement():
    """The refined f32 leaf (f32 factor + one Ozaki correction) reaches
    the refinement's own error floor, agrees with native f64 potrf, and
    keeps the non-PD info semantics (the f64 rescue path)."""
    A = latmc(jax.random.PRNGKey(5), 320, 100.0, jnp.float64)
    L0, i0 = blocked.potrf("L", A, backend="ozaki")
    L1, i1 = blocked.potrf("L", A, backend="xla")
    assert int(i0) == int(i1) == 0
    An = np.asarray(A)
    Af = np.tril(An) + np.tril(An, -1).T
    for L in (L0, L1):
        Ln = np.tril(np.asarray(L))
        r = np.max(np.abs(Ln @ Ln.T - Af)) / np.max(np.abs(Af))
        assert r < 320 * 2.0 ** -40, r
    agree = np.max(np.abs(np.asarray(L0) - np.asarray(L1))) \
        / np.max(np.abs(np.asarray(L0)))
    assert agree < 1e-9, agree
    # non-PD: the pivot comes out of the f64 rescue
    Abad = np.array(Af)
    Abad[100, 100] = -3.0
    _, ib = blocked.potrf("L", jnp.asarray(Abad), backend="ozaki")
    assert int(ib) == 101
