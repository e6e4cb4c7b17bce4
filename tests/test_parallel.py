"""Multi-chip tier on the virtual 8-device CPU mesh.

The analog of the reference's test/lapack/cumultigpu*.c tests, which run on
however many devices exist (reference cumultigpuspotrf.c:50-57); here the
mesh is the 8 virtual CPU devices from conftest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from cholesky_tpu.parallel import blockcyclic, potrf as dpotrf
from cholesky_tpu.rng import generators
from tests.util import assert_close, to_np128


@pytest.fixture(scope="module")
def mesh():
    devs = np.array(jax.devices())
    return Mesh(devs, ("d",))


def spd(n, dtype=jnp.float32, cond=50.0, seed=0):
    return generators.latmc(jax.random.PRNGKey(seed), n, cond, dtype)


def test_distribute_collect_roundtrip(mesh):
    A = spd(200)
    bc = blockcyclic.distribute(A, mesh, nb=16)
    # padded to a multiple of nb*P = 128 → 256
    assert bc.npad == 256
    back = blockcyclic.collect(bc)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(A))


def test_distribute_layout_cyclic(mesh):
    n, nb = 256, 16
    A = jnp.arange(n * n, dtype=jnp.float32).reshape(n, n)
    bc = blockcyclic.distribute(A, mesh, nb=nb)
    # device d's first local block must be global block d (cyclic layout)
    shards = {d.device.id: np.asarray(d.data) for d in bc.local.addressable_shards}
    p = len(shards)
    for dev, shard in shards.items():
        np.testing.assert_array_equal(shard[0], np.asarray(A[dev * nb:(dev + 1) * nb]))
        np.testing.assert_array_equal(shard[1], np.asarray(A[(dev + p) * nb:(dev + p + 1) * nb]))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64, jnp.complex64])
@pytest.mark.parametrize("n,nb", [pytest.param(256, 16, marks=pytest.mark.slow),
                                  pytest.param(200, 16, marks=pytest.mark.slow),
                                  (333, 32)])
def test_potrf_dist(mesh, dtype, n, nb):
    A = spd(n, dtype, seed=1)
    F, info = dpotrf.potrf_sharded("L", A, mesh, nb=nb)
    assert int(info) == 0
    ref = np.linalg.cholesky(to_np128(A))
    assert_close(np.tril(np.asarray(F)), ref, dtype, 8 * n, "potrf_dist")
    # strict upper untouched
    np.testing.assert_array_equal(np.triu(np.asarray(F), 1),
                                  np.triu(np.asarray(A), 1))


def test_potrf_dist_upper(mesh):
    A = spd(192, seed=2)
    F, info = dpotrf.potrf_sharded("U", A, mesh, nb=16)
    assert int(info) == 0
    ref = np.linalg.cholesky(to_np128(A)).T
    assert_close(np.triu(np.asarray(F)), np.triu(ref), jnp.float32, 8 * 192,
                 "potrf_dist upper")


def test_potrf_dist_nonpd_info(mesh):
    A = np.asarray(spd(256, seed=3)).copy()
    A[100, 100] = -2.0
    A = jnp.asarray(0.5 * (A + A.T))
    F, info = dpotrf.potrf_sharded("L", A, mesh, nb=16)
    assert 1 <= int(info) <= 101
    assert np.isfinite(np.asarray(F)).all()


def test_potrf_dist_matches_single_chip(mesh):
    # multi-chip must agree with the single-chip blocked driver
    from cholesky_tpu.ops import blocked
    A = spd(256, seed=4)
    Fd, _ = dpotrf.potrf_sharded("L", A, mesh, nb=32)
    Fs, _ = blocked.potrf("L", A, backend="xla", block_size=32)
    assert_close(np.tril(np.asarray(Fd)), np.tril(np.asarray(Fs)),
                 jnp.float32, 16 * 256, "dist vs single")


@pytest.mark.parametrize("n", [256, pytest.param(300, marks=pytest.mark.slow)])
def test_logdet_dist(mesh, n):
    A = spd(n, cond=20.0, seed=5)
    val, info = dpotrf.logdet_sharded("L", A, mesh, nb=32)
    assert int(info) == 0
    _, ref = np.linalg.slogdet(to_np128(A))
    assert_close(np.asarray(val), np.asarray(ref), jnp.float32, 60 * n,
                 "logdet_dist")


def test_potrf_dist_under_jit(mesh):
    # the whole distribute→factor→collect pipeline must be jittable
    A = spd(256, seed=6)

    @jax.jit
    def run(a):
        return dpotrf.potrf_sharded("L", a, mesh, nb=32)

    F, info = run(A)
    assert int(info) == 0
    ref = np.linalg.cholesky(to_np128(A))
    assert_close(np.tril(np.asarray(F)), ref, jnp.float32, 8 * 256,
                 "potrf_dist jit")


@pytest.mark.parametrize("phases", [1, 3, pytest.param(4, marks=pytest.mark.slow)])
def test_potrf_dist_phases_agree(mesh, phases):
    # the K-phase shrinking-width trailing update must be numerically
    # IDENTICAL work partitioning — results agree to f32 roundoff across K
    A = spd(300, seed=7)
    F, info = dpotrf.potrf_sharded("L", A, mesh, nb=16, phases=phases)
    assert int(info) == 0
    ref = np.linalg.cholesky(to_np128(A))
    assert_close(np.tril(np.asarray(F)), ref, jnp.float32, 8 * 300,
                 f"potrf_dist phases={phases}")


@pytest.mark.slow   # Ozaki-interpret leaves: heaviest single test
def test_potrf_dist_fast_f64_tiles(mesh):
    # tiles='ozaki' runs the Ozaki leaves (the dist tier runs the same
    # tiles as the single-device driver); accuracy is Ozaki-class (~2^-42
    # products + refinement), far inside the 1e-6 BASELINE target but
    # wider than native f64 — hence the widened bound
    n = 256
    A = spd(n, jnp.float64, seed=8)
    F, info = dpotrf.potrf_sharded("L", A, mesh, nb=128, tiles="ozaki")
    assert int(info) == 0
    ref = np.linalg.cholesky(to_np128(A))
    diff = np.max(np.abs(np.tril(np.asarray(F)) - ref))
    assert diff < 1e-9, diff


def test_potrf_dist_fast_f32_nonpd(mesh):
    # non-PD through the device-solver leaves (rescued by the sweep):
    # correct 1-based pivot, finite
    A = np.asarray(spd(256, seed=9)).copy()
    A[130, 130] = -3.0
    A = jnp.asarray(0.5 * (A + A.T))
    F, info = dpotrf.potrf_sharded("L", A, mesh, nb=128)
    assert 1 <= int(info) <= 131
    assert np.isfinite(np.asarray(F)).all()


def test_potrf_dist_lookahead_agrees(mesh):
    # pipelined diagonal (reference stream overlap, spotrf.c:311-313) vs
    # the serial round-2 step order: same factor to f32 roundoff (the
    # lookahead computes block (j+1,j+1)'s update as a separate nb×nb
    # matmul instead of a slice of the trailing GEMM)
    A = spd(300, seed=11)
    Fl, il = dpotrf.potrf_sharded("L", A, mesh, nb=16, lookahead=True)
    Fs, is_ = dpotrf.potrf_sharded("L", A, mesh, nb=16, lookahead=False)
    assert int(il) == int(is_) == 0
    assert_close(np.tril(np.asarray(Fl)), np.tril(np.asarray(Fs)),
                 jnp.float32, 8 * 300, "lookahead vs serial")
    ref = np.linalg.cholesky(to_np128(A))
    assert_close(np.tril(np.asarray(Fl)), ref, jnp.float32, 8 * 300,
                 "lookahead vs numpy")


def test_potrf_dist_lookahead_nonpd(mesh):
    # freeze-at-failure semantics must survive the pipelined carry: the
    # lookahead factor of a garbage block past the failing step is never
    # consumed
    A = np.asarray(spd(256, seed=12)).copy()
    A[77, 77] = -1.0
    A = jnp.asarray(0.5 * (A + A.T))
    F, info = dpotrf.potrf_sharded("L", A, mesh, nb=16, lookahead=True)
    assert 1 <= int(info) <= 78
    assert np.isfinite(np.asarray(F)).all()
    Fs, infos = dpotrf.potrf_sharded("L", A, mesh, nb=16, lookahead=False)
    assert int(info) == int(infos)


def _shard_bytes(x):
    return [np.asarray(s.data).tobytes() for s in x.addressable_shards]


def test_potrf_dist_cross_device_agreement(mesh):
    # the replicated outputs of the dist tier must be
    # BIT-identical on every device — any divergence means a device
    # computed from stale/wrong collective data and the P() out_spec is
    # papering over it
    A = spd(256, seed=13)
    bc = blockcyclic.distribute(A, mesh, nb=16)
    fbc, info = dpotrf.potrf_dist(bc)
    ib = _shard_bytes(info)
    assert len(ib) == len(mesh.devices.ravel())
    assert all(b == ib[0] for b in ib), "info differs across devices"
    F = blockcyclic.collect(fbc)         # replicated collect
    fb = _shard_bytes(F)
    assert all(b == fb[0] for b in fb), "collected factor differs across devices"


def test_logdet_dist_cross_device_agreement(mesh):
    A = spd(256, cond=20.0, seed=14)
    bc = blockcyclic.distribute(A, mesh, nb=16)
    val, info = dpotrf.logdet_dist(bc)
    vb = _shard_bytes(val)
    assert all(b == vb[0] for b in vb), "logdet differs across devices"
    ib = _shard_bytes(info)
    assert all(b == ib[0] for b in ib)
