"""Public API × s/d/c/z lowered for CUDA: the GPU route of every call.

Each public driver and BLAS op is AOT-lowered for the ``cuda`` platform
from the CPU test process (lowering compiles nothing, so the grid is
cheap). The program must hold no other accelerator's kernel call (no
``tpu_custom_call``, no Mosaic op), and in the single-precision dtypes
every ``dot_general`` must ask for HIGHEST precision: a default-precision
f32 product may run in TF32 on the GPU (~1e-3 relative error), which
would silently break the library's eps-scaled accuracy bounds.
"""

import re

import jax
import jax.numpy as jnp
import pytest

import cholesky_tpu as ct

N, NRHS = 256, 64

OPS = {
    "potrf": lambda a, b: ct.potrf("L", a),
    "potf2": lambda a, b: ct.potf2("L", a),
    "trtri": lambda a, b: ct.trtri("L", "N", a),
    "trti2": lambda a, b: ct.trti2("L", "N", a),
    "lauum": lambda a, b: ct.lauum("L", a),
    "lauu2": lambda a, b: ct.lauu2("L", a),
    "potri": lambda a, b: ct.potri("L", a),
    "logdet": lambda a, b: ct.logdet("L", a),
    "gemm": lambda a, b: ct.gemm("N", "N", 1.0, a, b, 0.0, b),
    "syrk": lambda a, b: ct.syrk("L", "N", -1.0, b, 1.0, a),
    "herk": lambda a, b: ct.herk("L", "N", -1.0, b, 1.0, a),
    "trmm": lambda a, b: ct.trmm("L", "L", "N", "N", 1.0, a, b),
    "trsm": lambda a, b: ct.trsm("L", "L", "N", "N", 1.0, a, b),
}
DTYPES = {"s": jnp.float32, "d": jnp.float64, "c": jnp.complex64,
          "z": jnp.complex128}


def _lower(fn, dtype):
    a = jax.ShapeDtypeStruct((N, N), dtype)
    b = jax.ShapeDtypeStruct((N, NRHS), dtype)
    return jax.jit(fn).trace(a, b).lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("letter", list(DTYPES))
@pytest.mark.parametrize("op", list(OPS))
def test_public_op_lowers_for_cuda(op, letter):
    txt = _lower(OPS[op], DTYPES[letter])
    assert "tpu_custom_call" not in txt
    assert "mosaic" not in txt.lower()
    dots = re.findall(r"stablehlo\.dot_general[^\n]*", txt)
    if letter in "sc":
        loose = [d for d in dots if "precision = [HIGHEST, HIGHEST]" not in d]
        assert not loose, f"{op}/{letter}: {loose[0][:200]}"


@pytest.mark.parametrize("letter", list(DTYPES))
def test_potrf_leaf_is_cusolver(letter):
    # the diagonal block is factored on the device by cuSOLVER, with the
    # oracle sweep kept only as the rescue branch of a conditional
    txt = _lower(OPS["potrf"], DTYPES[letter])
    assert "cusolver_potrf" in txt
    assert "stablehlo.case" in txt or "stablehlo.if" in txt
