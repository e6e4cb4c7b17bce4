"""Backend routing rules (the mangled-name dispatch analog, trace-time)."""

import jax.numpy as jnp
import pytest

import cholesky_tpu as ct
from cholesky_tpu.ops import blocked
from cholesky_tpu.utils.benchlib import bench_op


def test_fast_tiles_routing():
    # real dtypes → XLA tiles under 'auto' and 'xla', on every platform
    for dt in (jnp.float32, jnp.float64):
        for b in ("auto", "xla"):
            t = blocked._fast_tiles_or_none(dt, b)
            assert type(t) is blocked._XlaTiles and t.dtype == jnp.dtype(dt)
    # f64 explicit ozaki
    assert isinstance(blocked._fast_tiles_or_none(jnp.float64, "ozaki"),
                      blocked._OzakiTiles)
    # complex never gets a tile here: it runs natively through blas_ref
    assert blocked._fast_tiles_or_none(jnp.complex64, "auto") is None
    assert blocked._fast_tiles_or_none(jnp.complex64, "xla") is None


def test_tiles_for_backend_validation():
    with pytest.raises(ValueError):
        blocked._tiles_for(jnp.float64, "pallas")
    with pytest.raises(ValueError):
        blocked._tiles_for(jnp.float32, "ozaki")


#: the route table: dtype × backend → what a blocked driver runs on.
#: "native" = XLA tiles at the operand's own dtype; "embed" = the real
#: embedding (ops/complex_embed.py); "error" = xerbla-style ValueError.
ROUTES = {
    ("s", "auto"): "native", ("s", "xla"): "native",
    ("s", "ozaki"): "error", ("s", "embed"): "error",
    ("s", "pallas"): "error",
    ("d", "auto"): "native", ("d", "xla"): "native",
    ("d", "ozaki"): "ozaki", ("d", "embed"): "error",
    ("d", "pallas"): "error",
    ("c", "auto"): "native", ("c", "xla"): "native",
    ("c", "ozaki"): "error", ("c", "embed"): "embed",
    ("c", "pallas"): "error",
    ("z", "auto"): "native", ("z", "xla"): "native",
    ("z", "ozaki"): "error", ("z", "embed"): "embed",
    ("z", "pallas"): "error",
}
DTYPES = {"s": jnp.float32, "d": jnp.float64, "c": jnp.complex64,
          "z": jnp.complex128}


def _route(dtype, backend):
    A = jnp.zeros((4, 4), dtype)
    if blocked._route_complex(A, backend):
        return "embed"
    try:
        t = blocked._tiles_for(dtype, backend)
    except ValueError:
        return "error"
    if isinstance(t, blocked._OzakiTiles):
        return "ozaki"
    assert type(t) is blocked._XlaTiles and t.dtype == jnp.dtype(dtype)
    return "native"


@pytest.mark.parametrize("letter,backend", sorted(ROUTES))
def test_route_table(letter, backend):
    assert _route(DTYPES[letter], backend) == ROUTES[(letter, backend)]


@pytest.mark.parametrize("letter", list(DTYPES))
def test_pallas_backend_raises_through_public_api(letter):
    # the removed backend must never reroute quietly: every public entry
    # point rejects it through xerbla
    A = jnp.eye(8, dtype=DTYPES[letter])
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        ct.potrf("L", A, backend="pallas")
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        ct.trsm("L", "L", "N", "N", 1.0, A, A, backend="pallas")
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        blocked.gemm("N", "N", 1.0, A, A, 0.0, A, backend="pallas")


def test_benchlib_measures_positive_time():
    x = jnp.ones((64, 64), jnp.float32)
    t = bench_op(lambda v: v * 2.0 + 1.0, x, chain=4, reps=2)
    assert t > 0.0
