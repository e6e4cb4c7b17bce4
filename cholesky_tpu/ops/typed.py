"""Precision-prefixed API parity layer: s/d/c/z wrappers.

The reference exposes every routine in four explicitly-typed variants
(sgemm/dgemm/cgemm/zgemm, spotrf/dpotrf/cpotrf/zpotrf, …, reference
include/blas.h and include/lapack.h); here they are thin dtype-checked
wrappers over the generic drivers — the reference generates its d/z
sources from s/c by sed (single2double.sh), we generate wrappers from one
generic source at import time.
"""

from __future__ import annotations

import sys

import jax.numpy as jnp

from cholesky_tpu.ops import dispatch
from cholesky_tpu.types import PRECISIONS
from cholesky_tpu.utils.errors import check

_BLAS = ["gemm", "syrk", "trmm", "trmm2", "trsm"]
_BLAS_COMPLEX_RK = {"c": "herk", "z": "herk"}  # cherk/zherk replace syrk's 'C'
_LAPACK = ["potrf", "potf2", "trtri", "trtri2", "trti2", "lauum", "lauu2",
           "potri", "logdet"]

# which positional argument carries the typed matrix, per routine family
_MATRIX_ARG = {
    "gemm": 3, "syrk": 3, "herk": 3, "trmm": 5, "trmm2": 5, "trsm": 5,
    "potrf": 1, "potf2": 1, "trtri": 2, "trtri2": 2, "trti2": 2,
    "lauum": 1, "lauu2": 1, "potri": 1, "logdet": 1,
}


def _make(letter: str, name: str):
    dtype = jnp.dtype(PRECISIONS[letter])
    # the (re, im) pair form of a complex operand (the embedding tier's
    # entry); pairs carry the matching real dtype planes
    pair_dtype = {"c": jnp.dtype(jnp.float32), "z": jnp.dtype(jnp.float64)
                  }.get(letter)
    generic = getattr(dispatch, name)
    argpos = _MATRIX_ARG[name]

    def typed(*args, **kwargs):
        A = args[argpos]
        if isinstance(A, tuple):
            check(pair_dtype is not None
                  and jnp.dtype(A[0].dtype) == pair_dtype, letter + name,
                  argpos + 1,
                  f"(re, im) pair must carry {pair_dtype} planes for "
                  f"{letter}{name}, got {A[0].dtype}")
        else:
            check(jnp.dtype(A.dtype) == dtype, letter + name, argpos + 1,
                  f"expected {dtype}, got {A.dtype}")
        return generic(*args, **kwargs)

    typed.__name__ = letter + name
    typed.__qualname__ = letter + name
    typed.__doc__ = (f"{dtype}-typed {name} (reference {letter}{name}); "
                     f"see the generic ``{name}`` for semantics.")
    return typed


_mod = sys.modules[__name__]
__all__ = []
for _letter in PRECISIONS:
    for _name in _BLAS + _LAPACK:
        if _name == "syrk" and _letter in ("c", "z"):
            # the reference implements no csyrk/zsyrk — the complex
            # rank-k update is HERK (include/blas.h:57-66; blas/ has
            # only ssyrk/dsyrk + cherk/zherk)
            continue
        _fn = _make(_letter, _name)
        setattr(_mod, _letter + _name, _fn)
        __all__.append(_letter + _name)
    # cherk / zherk (complex rank-k with real alpha/beta)
    if _letter in ("c", "z"):
        _fn = _make(_letter, "herk")
        setattr(_mod, _letter + "herk", _fn)
        __all__.append(_letter + "herk")
