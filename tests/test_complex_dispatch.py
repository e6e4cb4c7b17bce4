"""Complex routing through the PUBLIC API.

'auto' keeps native XLA complex; backend='embed' (or (re, im) pair
operands) sends complex operands through the real embedding onto the real
tiles (c64 → f32, c128 → f64) — these tests exercise the routing and the
embedded numerics on the CPU mesh.
(Reference bar: every routine is first-class in c/z,
reference include/lapack.h:16-158.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cholesky_tpu as ct
from cholesky_tpu.ops import blocked
from cholesky_tpu.rng import generators
from tests.util import assert_close, to_np128

CPLX = [jnp.complex64, jnp.complex128]


def hpd(n, dtype, seed=0):
    return generators.latmc(jax.random.PRNGKey(seed), n, 50.0, dtype)


def crand(seed, shape, dtype):
    from cholesky_tpu.types import real_dtype
    rdt = real_dtype(dtype)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return jax.lax.complex(
        jax.random.uniform(k1, shape, rdt) - 0.5,
        jax.random.uniform(k2, shape, rdt) - 0.5).astype(dtype)


def test_route_complex_policy():
    # pairs always take the embedding; complex arrays only under 'embed';
    # real never does
    re = jnp.zeros((4, 4), jnp.float64)
    assert blocked._route_complex((re, re), "auto")
    assert blocked._route_complex((re, re), "xla")
    z = jnp.zeros((4, 4), jnp.complex64)
    assert blocked._route_complex(z, "embed")
    assert not blocked._route_complex(z, "auto")   # 'auto' keeps native
    assert not blocked._route_complex(z, "xla")
    assert not blocked._route_complex(re, "auto")
    assert not blocked._route_complex(re, "embed")


def test_embed_backend_rejects_real():
    A = jnp.eye(8, dtype=jnp.float32)
    with pytest.raises(ValueError):
        blocked.potrf("L", A, backend="embed")
    with pytest.raises(ValueError):
        blocked.gemm("N", "N", 1.0, A, A, 0.0, A, backend="embed")


@pytest.mark.parametrize("dtype", CPLX)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_embed_public(dtype, uplo):
    n = 80
    A = hpd(n, dtype)
    F, info = ct.potrf(uplo, A, backend="embed")
    assert int(info) == 0
    L = np.linalg.cholesky(to_np128(A))
    ref = L if uplo == "L" else L.conj().T
    tri = np.tril if uplo == "L" else np.triu
    assert_close(tri(np.asarray(F)), tri(ref), dtype, 8 * n,
                 f"potrf embed {uplo}")
    # opposite strict triangle untouched
    anti = (np.triu(np.asarray(F), 1) if uplo == "L"
            else np.tril(np.asarray(F), -1))
    anti_in = (np.triu(np.asarray(A), 1) if uplo == "L"
               else np.tril(np.asarray(A), -1))
    np.testing.assert_array_equal(anti, anti_in)


@pytest.mark.parametrize("dtype", CPLX)
def test_trtri_lauum_potri_logdet_embed_public(dtype):
    n = 64
    A = hpd(n, dtype, seed=1)
    F, _ = ct.potrf("L", A, backend="embed")
    W, info = ct.trtri("L", "N", F, backend="embed")
    assert int(info) == 0
    Lref = np.linalg.cholesky(to_np128(A))
    assert_close(np.tril(np.asarray(W)), np.linalg.inv(Lref), dtype,
                 20 * n, "trtri embed")
    P, info = ct.potri("L", F, backend="embed")
    assert int(info) == 0
    assert_close(np.tril(np.asarray(P)), np.tril(np.linalg.inv(to_np128(A))),
                 dtype, 40 * n, "potri embed")
    val, info = ct.logdet("L", A, backend="embed")
    ref = np.linalg.slogdet(to_np128(A))[1]
    assert abs(float(val) - ref) < 1e-3 if dtype == jnp.complex64 \
        else abs(float(val) - ref) < 1e-9


@pytest.mark.parametrize("dtype", CPLX)
@pytest.mark.parametrize("side,uplo,trans,diag",
                         [("L", "L", "N", "N"), ("L", "U", "C", "N"),
                          ("R", "L", "T", "U"), ("R", "U", "N", "N")])
def test_trsm_embed_public(dtype, side, uplo, trans, diag):
    n, m = 48, 24
    na = n if side == "L" else m
    A = generators.random_triangular(jax.random.PRNGKey(5), na, uplo, diag,
                                     dtype)
    B = crand(6, (n, m), dtype)
    X = ct.trsm(side, uplo, trans, diag, 1.5, A, B, backend="embed")
    T = to_np128(A)
    T = np.tril(T) if uplo == "L" else np.triu(T)
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    T = {"N": T, "T": T.T, "C": T.conj().T}[trans]
    Bn = 1.5 * to_np128(B)
    ref = np.linalg.solve(T, Bn) if side == "L" \
        else np.linalg.solve(T.T, Bn.T).T
    assert_close(np.asarray(X), ref, dtype, 40 * na,
                 f"trsm embed {side}{uplo}{trans}{diag}")


@pytest.mark.parametrize("dtype", CPLX)
@pytest.mark.parametrize("ta,tb", [("N", "N"), ("C", "N"), ("N", "T")])
def test_gemm_embed_public(dtype, ta, tb):
    m, k, n = 40, 24, 32
    A = crand(7, (m, k) if ta == "N" else (k, m), dtype)
    B = crand(8, (k, n) if tb == "N" else (n, k), dtype)
    C = crand(9, (m, n), dtype)
    out = ct.gemm(ta, tb, 0.7, A, B, -0.4, C, backend="embed")
    An = to_np128(A)
    An = {"N": An, "T": An.T, "C": An.conj().T}[ta]
    Bn = to_np128(B)
    Bn = {"N": Bn, "T": Bn.T, "C": Bn.conj().T}[tb]
    ref = 0.7 * An @ Bn - 0.4 * to_np128(C)
    assert_close(np.asarray(out), ref, dtype, 8 * k + 6,
                 f"gemm embed {ta}{tb}")


@pytest.mark.parametrize("dtype", CPLX)
@pytest.mark.parametrize("uplo,trans", [("L", "N"), ("U", "C")])
def test_herk_embed_public(dtype, uplo, trans):
    n, k = 40, 24
    A = crand(10, (n, k) if trans == "N" else (k, n), dtype)
    C = crand(11, (n, n), dtype)
    out = ct.herk(uplo, trans, 0.9, A, -0.2, C, backend="embed")
    An = to_np128(A)
    An = An if trans == "N" else An.conj().T
    full = 0.9 * (An @ An.conj().T) - 0.2 * to_np128(C)
    # herk reads only the selected triangle of C (Hermitian completion)
    cc = to_np128(C)
    herm = (np.tril(cc) + np.tril(cc, -1).conj().T if uplo == "L"
            else np.triu(cc) + np.triu(cc, 1).conj().T)
    full = 0.9 * (An @ An.conj().T) - 0.2 * herm
    np.fill_diagonal(full, full.diagonal().real)
    mask = np.tril(np.ones((n, n))) if uplo == "L" \
        else np.triu(np.ones((n, n)))
    ref = np.where(mask > 0, full, cc)
    assert_close(np.asarray(out), ref, dtype, 8 * k + 6,
                 f"herk embed {uplo}{trans}")
    # diagonal exactly real
    np.testing.assert_array_equal(np.diag(np.asarray(out)).imag, 0.0)


@pytest.mark.parametrize("dtype", CPLX)
@pytest.mark.parametrize("side,uplo,trans,diag",
                         [("L", "L", "N", "N"), ("L", "U", "C", "U"),
                          ("R", "U", "T", "N")])
def test_trmm_embed_public(dtype, side, uplo, trans, diag):
    m, n = 40, 24
    na = m if side == "L" else n
    A = generators.random_triangular(jax.random.PRNGKey(12), na, uplo, diag,
                                     dtype)
    B = crand(13, (m, n), dtype)
    out = ct.trmm(side, uplo, trans, diag, 1.1, A, B, backend="embed")
    T = to_np128(A)
    T = np.tril(T) if uplo == "L" else np.triu(T)
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    T = {"N": T, "T": T.T, "C": T.conj().T}[trans]
    ref = 1.1 * (T @ to_np128(B) if side == "L" else to_np128(B) @ T)
    assert_close(np.asarray(out), ref, dtype, 8 * na + 4,
                 f"trmm embed {side}{uplo}{trans}{diag}")


def test_typed_pair_form():
    # the (re, im) pair form — the embedding's entry for z routines — through the
    # typed API: zpotrf on planes returns planes
    n = 64
    A = hpd(n, jnp.complex128, seed=2)
    re, im = jnp.real(A), jnp.imag(A)
    out, info = ct.zpotrf("L", (re, im))
    assert isinstance(out, tuple)
    assert int(info) == 0
    F = np.asarray(out[0]) + 1j * np.asarray(out[1])
    ref = np.linalg.cholesky(to_np128(A))
    assert_close(np.tril(F), ref, jnp.complex128, 8 * n, "zpotrf pair")
    # pair with wrong-width planes must xerbla
    with pytest.raises(ValueError):
        ct.cpotrf("L", (re, im))   # f64 planes into the c-variant


def test_pair_form_public_drivers():
    n = 48
    A = hpd(n, jnp.complex128, seed=3)
    re, im = jnp.real(A), jnp.imag(A)
    F, info = ct.potrf("L", (re, im))
    assert isinstance(F, tuple) and int(info) == 0
    W, info = ct.trtri("L", "N", F)
    assert isinstance(W, tuple) and int(info) == 0
    val, info = ct.logdet("L", (re, im))
    ref = np.linalg.slogdet(to_np128(A))[1]
    assert abs(float(val) - ref) < 1e-9
