"""Backend dispatch: route ops to the ref tier or the blocked drivers.

The reference selects implementations by linking one of three tiers
(include/blas.h:29-34) and by snprintf-ing mangled kernel names at runtime
(blas/sgemm.c:184-190); here selection is plain Python specialization at
trace time, keyed on dtype and backend.
"""

from __future__ import annotations

import functools

import jax

from cholesky_tpu.ops import blas_ref, lapack_ref
from cholesky_tpu.utils.errors import check

_BACKENDS = ("auto", "ref", "xla", "ozaki", "embed")


def _resolve(backend: str | None) -> str:
    """Validate a backend name; unknown names raise through xerbla."""
    b = backend or "auto"
    check(b in _BACKENDS, "backend", 0,
          f"unknown backend {b!r}; expected one of {_BACKENDS}")
    return b


def _wrap_blas(name):
    ref_fn = getattr(blas_ref, name)

    @functools.wraps(ref_fn)
    def fn(*args, backend: str | None = None, **kwargs):
        b = _resolve(backend)
        if b != "ref":
            from cholesky_tpu.ops import blocked
            impl = getattr(blocked, name, None)
            if impl is not None:
                return impl(*args, backend=b, **kwargs)
        return ref_fn(*args, **kwargs)

    return fn


def _wrap_lapack(name):
    ref_fn = getattr(lapack_ref, name)

    @functools.wraps(ref_fn)
    def fn(*args, backend: str | None = None, **kwargs):
        b = _resolve(backend)
        if b != "ref":
            from cholesky_tpu.ops import blocked
            impl = getattr(blocked, name, None)
            if impl is not None:
                return impl(*args, backend=b, **kwargs)
        return ref_fn(*args, **kwargs)

    return fn


gemm = _wrap_blas("gemm")
syrk = _wrap_blas("syrk")
herk = _wrap_blas("herk")
trmm = _wrap_blas("trmm")
trmm2 = _wrap_blas("trmm2")
trsm = _wrap_blas("trsm")

potrf = _wrap_lapack("potrf")
potf2 = _wrap_lapack("potf2")
trtri = _wrap_lapack("trtri")
trtri2 = _wrap_lapack("trtri2")
trti2 = _wrap_lapack("trti2")
lauum = _wrap_lapack("lauum")
lauu2 = _wrap_lapack("lauu2")
potri = _wrap_lapack("potri")
logdet = _wrap_lapack("logdet")
logdet_from_factor = lapack_ref.logdet_from_factor
