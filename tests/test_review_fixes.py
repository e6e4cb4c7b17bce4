"""Regression tests for the round-2 self-review findings: frozen-pivot
finiteness through the Ozaki refinement, pair-operand coverage of every
typed c/z routine, complex static alpha through the embedding, explicit
backend forwarding, and clean errors where no path exists."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cholesky_tpu as ct
from cholesky_tpu.ops import blocked, complex_embed
from cholesky_tpu.rng import generators
from tests.util import to_np128


def hpd_pair(n, rdt=jnp.float64, seed=0, cond=50.0):
    return generators.latmc_pair(jax.random.PRNGKey(seed), n, cond, rdt)


def test_ozaki_potf2_nonpd_stays_finite():
    # the frozen leaf leaves the raw (<=0) pivot on the f32 diagonal; the
    # refinement's triangular solves must not divide by it (review #1)
    A = np.eye(64)
    A[10, 10] = 0.0
    F, info = blocked.potrf("L", jnp.asarray(A), backend="ozaki")
    assert int(info) == 11
    assert np.isfinite(np.asarray(F)).all()
    # the leading 10x10 block is still exactly factored (break semantics)
    np.testing.assert_allclose(np.asarray(F)[:10, :10], np.eye(10),
                               atol=1e-9)


def test_ozaki_potf2_near_singular_finite():
    # PD in f64 (det = 1e-12) but pivot ~0 at f32: the f64 rescue
    # re-factors the flagged leaf at true f64, so
    # this now factors with info=0 — matching reference dpotrf. The
    # finite-output guarantee is unchanged.
    A = jnp.asarray([[1.0, 0.5], [0.5, 0.25 + 1e-12]])
    F, info = blocked.potrf("L", A, backend="ozaki")
    assert int(info) == 0
    assert np.isfinite(np.asarray(F)).all()
    L = np.tril(np.asarray(F))
    assert np.max(np.abs(L @ L.T - np.asarray(A))) < 1e-12
    # a genuinely singular-at-f64 matrix still reports the pivot
    B = jnp.asarray([[1.0, 0.5], [0.5, 0.25]])
    FB, ib = blocked.potrf("L", B, backend="ozaki")
    assert int(ib) == 2
    assert np.isfinite(np.asarray(FB)).all()


def test_pair_trti2_lauu2_route():
    # typed c/z trti2/lauu2 on pairs must work, not AttributeError (#2)
    n = 32
    ar, ai = hpd_pair(n)
    fr, fi = blocked.potrf("L", (ar, ai))[0]
    wr, wi = ct.ztrti2("L", "N", (fr, fi))[0]
    W = np.tril(np.asarray(wr)) + 1j * np.tril(np.asarray(wi, np.float64), -1)
    Fc = np.tril(np.asarray(fr)) + 1j * np.tril(np.asarray(fi), -1)
    resid = np.max(np.abs(W @ Fc - np.eye(n)))
    assert resid < 1e-8, resid
    pr, pi = ct.zlauu2("L", (wr, wi))
    ref = np.tril(W.conj().T @ W)
    got = np.tril(np.asarray(pr)) + 1j * np.tril(np.asarray(pi), -1)
    assert np.max(np.abs(got - ref)) < 1e-8


def test_zsyrk_absent_and_pair_syrk_clean_error():
    # reference has no csyrk/zsyrk; pairs get a clean xerbla (#2)
    assert not hasattr(ct, "zsyrk")
    ar, ai = hpd_pair(16)
    with pytest.raises(ValueError, match="HERK"):
        blocked.syrk("L", "N", 1.0, (ar, ai), 0.0, (ar, ai))


def test_pair_gemm_complex_alpha():
    # reference cgemm takes complex alpha (include/blas.h:180-190) (#3)
    n = 24
    ar, ai = hpd_pair(n, seed=1)
    br, bi = hpd_pair(n, seed=2)
    cr = jnp.zeros((n, n), jnp.float64)
    rr, ri = blocked.gemm("N", "N", 1 + 2j, (ar, ai), (br, bi),
                          0.5 - 1j, (cr, cr))
    A = np.asarray(ar) + 1j * np.asarray(ai)
    B = np.asarray(br) + 1j * np.asarray(bi)
    ref = (1 + 2j) * (A @ B)
    got = np.asarray(rr) + 1j * np.asarray(ri)
    assert np.max(np.abs(got - ref)) < 1e-8 * np.max(np.abs(ref))


def test_pair_trsm_complex_alpha():
    n = 32
    ar, ai = hpd_pair(n, seed=3)
    fr, fi = blocked.potrf("L", (ar, ai))[0]
    br, bi = hpd_pair(n, seed=4)
    xr, xi = blocked.trsm("L", "L", "N", "N", 2 - 1j, (fr, fi), (br, bi))
    F = np.tril(np.asarray(fr)) + 1j * np.tril(np.asarray(fi), -1)
    B = np.asarray(br) + 1j * np.asarray(bi)
    X = np.asarray(xr) + 1j * np.asarray(xi)
    resid = np.max(np.abs(F @ X - (2 - 1j) * B))
    assert resid < 1e-7 * np.max(np.abs(X)) * np.max(np.abs(F))


def test_pair_gemm_traced_alpha_clean_error():
    # traced alpha cannot reach the embedding: clean xerbla, not
    # AttributeError (#3)
    ar, ai = hpd_pair(8)
    with pytest.raises(ValueError, match="static"):
        jax.jit(lambda a: blocked.gemm("N", "N", a, (ar, ai), (ar, ai),
                                       0.0, (ar, ai)))(jnp.float64(1.0))


def test_pair_backend_ref_honored():
    # backend='ref' must reach the real-plane ops, not be rewritten to
    # 'auto' (#4): verify via numerics on the oracle tier
    n = 24
    ar, ai = hpd_pair(n, seed=5)
    (fr1, fi1), i1 = blocked.potrf("L", (ar, ai), backend="ref")
    (fr2, fi2), i2 = blocked.potrf("L", (ar, ai), backend="auto")
    assert int(i1) == 0 and int(i2) == 0
    F1 = np.tril(np.asarray(fr1)) + 1j * np.tril(np.asarray(fi1), -1)
    A = np.asarray(ar) + 1j * np.asarray(ai)
    ref = np.linalg.cholesky(A)
    assert np.max(np.abs(F1 - ref)) < 1e-10
