"""cholesky_tpu: a dense linear algebra library in JAX, for NVIDIA GPUs.

A from-scratch rebuild of the capabilities of the CUDA ``cuda-cholesky``
reference library (see SURVEY.md): blocked Cholesky factorization (POTRF),
triangular inverse (TRTRI), triangular square (LAUUM), SPD/HPD inverse
(POTRI), and log-determinant (LOGDET), layered on Level-3 BLAS tiles
(GEMM / SYRK / HERK / TRMM / TRSM), in four precisions:

  s = float32        (FP32 products: ``config.matmul_precision`` is HIGHEST,
                      since XLA's default f32 matmul on the GPU may run in
                      TF32)
  d = float64        (native FP64; ``backend='ozaki'`` computes products as
                      exact int8 slices)
  c = complex64      (native; ``backend='embed'`` uses the real embedding)
  z = complex128     (native; same)

The reference's three tiers (CPU / single-GPU hybrid / multi-GPU task pool,
include/blas.h:29-34 in the reference) map to three tiers:

  ``*_ref``            pure-jnp reference implementations (the oracle tier,
                       analogous to the reference's CPU tier, blas/*.c)
  top-level ops        recursive blocked drivers over XLA tiles: cuBLAS
                       GEMMs and cuSOLVER/cuBLAS diagonal-block leaves
                       (analogous to the cu* single-GPU tier)
  ``parallel.*``       shard_map block-cyclic multi-device tier whose
                       collectives XLA hands to NCCL (analogous to the
                       cuMultiGPU* tier)
"""

from cholesky_tpu.types import Side, Uplo, Trans, Diag
from cholesky_tpu.utils.errors import (
    set_error_handler,
    set_xerbla,
    xerbla,
)
from cholesky_tpu.ops.api import (
    # BLAS L3 (generic, dtype-dispatched)
    gemm,
    syrk,
    herk,
    trmm,
    trmm2,
    trsm,
    # LAPACK drivers
    potrf,
    potf2,
    trtri,
    trtri2,
    trti2,
    lauum,
    lauu2,
    potri,
    logdet,
    logdet_from_factor,
)

from cholesky_tpu.ops import typed as _typed
from cholesky_tpu.ops.typed import *  # noqa: F401,F403 — s/d/c/z variants

# Tracing the recursive blocked drivers stacks driver frames × JAX tracer
# frames × (with x64) dtype-dispatch wrappers; the CPython default of 1000
# is not enough for deep factorizations. Same remedy JAX suggests for deep
# networks.
import sys as _sys

if _sys.getrecursionlimit() < 10000:
    _sys.setrecursionlimit(10000)

__version__ = "0.1.0"
