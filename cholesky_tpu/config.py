"""Library-wide configuration.

The reference's configuration mechanisms (SURVEY.md §5) map as:
- build-time autotuned include/config.h (block sizes, PCIe cost model)
  → fixed leaf block sizes on the tile backends (ops/blocked.py), since
  cuBLAS/cuSOLVER pick their own kernels for every call;
- global function-pointer hooks → utils/errors.py.

This module holds the one numerical knob the reference has no analog for:
the precision of f32 matrix products.
"""

from __future__ import annotations

from jax import lax

#: Matmul precision for f32 operands. On the GPU, XLA's *default* f32
#: matmul may run in TF32 (a 10-bit mantissa, ~1e-3 relative error) —
#: catastrophic for a linear algebra library. HIGHEST requests full FP32
#: products (no TF32). f64/complex128 paths are unaffected.
matmul_precision = lax.Precision.HIGHEST


def set_matmul_precision(p) -> None:
    global matmul_precision
    matmul_precision = p
