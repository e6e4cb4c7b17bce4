"""Every tile-layer kernel and f64 driver must lower for CUDA under x64.

The d/z drivers always run with ``jax_enable_x64``; these tests
AOT-lower each tile-layer building block and each auto-routed f64 driver
for the ``cuda`` platform from the CPU test process — the StableHLO the
GPU compiler receives, no card needed — and check that nothing in it
targets another accelerator: no ``tpu_custom_call`` and no Mosaic op.

Reference analog: the CUDA build compiles every kernel for the target
arch at build time (reference Makefile nvcc rules) — a broken kernel
cannot ship silently.
"""

import functools

import jax
import jax.numpy as jnp
import pytest

from cholesky_tpu.ops import blocked, ozaki


def lower_cuda(fn, *specs) -> str:
    """StableHLO text of ``fn`` lowered for the CUDA platform; fails if
    any op targets another accelerator's kernel compiler."""
    txt = jax.jit(fn).trace(*specs).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "tpu_custom_call" not in txt
    assert "mosaic" not in txt.lower()
    return txt


def _s(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


T32 = blocked._XlaTiles(jnp.float32)
T64 = blocked._XlaTiles(jnp.float64)
OZ = blocked._OzakiTiles()

KERNELS = [
    ("leaf_potf2", lambda: lower_cuda(T32.potf2, _s((256, 256))),
     "cusolver_potrf"),
    ("leaf_trti2", lambda: lower_cuda(T32.trti2, _s((256, 256))),
     "triangular_solve"),
    ("leaf_trti2_unit",
     lambda: lower_cuda(functools.partial(T32.trti2, unit=True),
                        _s((256, 256))), "triangular_solve"),
    ("leaf_lauu2", lambda: lower_cuda(T32.lauu2, _s((256, 256))),
     "dot_general"),
    ("leaf_potf2_f64",
     lambda: lower_cuda(T64.potf2, _s((256, 256), jnp.float64)),
     "cusolver_potrf"),
    ("leaf_trti2_f64",
     lambda: lower_cuda(T64.trti2, _s((256, 256), jnp.float64)),
     "triangular_solve"),
    ("ozaki_potf2", lambda: lower_cuda(OZ.potf2, _s((256, 256), jnp.float64)),
     "cusolver_potrf"),
    ("ozaki_trti2", lambda: lower_cuda(OZ.trti2, _s((256, 256), jnp.float64)),
     "xi32"),
    ("mm", lambda: lower_cuda(T32.mm, _s((512, 512)), _s((512, 512))),
     "dot_general"),
    ("syrk", lambda: lower_cuda(lambda a, c: T32.syrk_ln(-1.0, a, 1.0, c),
                                _s((512, 256)), _s((512, 512))),
     "dot_general"),
    ("trmm", lambda: lower_cuda(
        lambda a, b: blocked._trmm_lln_tiles(a, b, T32, 128),
        _s((512, 512)), _s((512, 512))), "dot_general"),
    ("ozaki_mm", lambda: lower_cuda(
        functools.partial(ozaki.matmul_f64, slices=6),
        _s((256, 256), jnp.float64), _s((256, 256), jnp.float64)),
     "tensor<256x256xi8>, tensor<256x256xi8>) -> tensor<256x256xi32>"),
    ("ozaki_peel", lambda: lower_cuda(
        lambda a: ozaki.split_rows(a, 6), _s((256, 256), jnp.float64)),
     "xi8"),
]


@pytest.mark.parametrize("name,low,marker", KERNELS,
                         ids=[k[0] for k in KERNELS])
def test_kernel_lowers_for_cuda_under_x64(name, low, marker):
    assert jax.config.jax_enable_x64  # conftest turns x64 on
    txt = low()
    # the route each tile is meant to take: cuSOLVER potrf, XLA's
    # triangular solve (cuBLAS trsm), or a dot_general (cuBLAS GEMM; int8
    # operands into int32 for the Ozaki slices)
    assert marker in txt, (name, marker)


DRIVERS = [
    ("potrf", lambda x: blocked.potrf("L", x, backend="auto")),
    ("trtri", lambda x: blocked.trtri("L", "N", x, backend="auto")),
    ("lauum", lambda x: blocked.lauum("L", x, backend="auto")),
    ("potri", lambda x: blocked.potri("L", x, backend="auto")),
    ("trmm", lambda x: blocked.trmm("L", "L", "N", "N", 1.0, x, x,
                                    backend="auto")),
    ("trsm", lambda x: blocked.trsm("L", "L", "N", "N", 1.0, x, x,
                                    backend="auto")),
]


@pytest.mark.parametrize("name,fn", DRIVERS, ids=[d[0] for d in DRIVERS])
def test_f64_driver_lowers_for_cuda(name, fn):
    """Every f64 driver's full auto-routed program lowers for CUDA with
    native f64 products (no int8 slices: 'auto' is native FP64)."""
    txt = lower_cuda(fn, _s((256, 256), jnp.float64))
    assert "xi8" not in txt


@pytest.mark.slow
def test_f64_potrf_lowers_at_mid_size():
    """n=2048 with the default leaf: a deep recursion, still CUDA-clean."""
    lower_cuda(lambda x: blocked.potrf("L", x, backend="auto"),
               _s((2048, 2048), jnp.float64))
