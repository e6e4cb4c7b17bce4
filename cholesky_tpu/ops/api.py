"""Public dtype-dispatched API.

Routes each routine to a tier by the ``backend`` argument:

  'ref'     pure-jnp oracle implementations (ops/blas_ref.py, lapack_ref.py)
  'xla'     blocked drivers over XLA matmuls and device solvers
            (ops/blocked.py)
  'ozaki'   the blocked drivers with f64 matmuls as exact int8-slice
            products (ops/ozaki.py)
  'embed'   complex operands through the real embedding
            (ops/complex_embed.py)

'auto' (default) is 'xla' for every dtype; see ops/dispatch.py.
"""

from __future__ import annotations

from cholesky_tpu.ops import dispatch as _dispatch

# BLAS L3
gemm = _dispatch.gemm
syrk = _dispatch.syrk
herk = _dispatch.herk
trmm = _dispatch.trmm
trmm2 = _dispatch.trmm2
trsm = _dispatch.trsm

# LAPACK
potrf = _dispatch.potrf
potf2 = _dispatch.potf2
trtri = _dispatch.trtri
trtri2 = _dispatch.trtri2
trti2 = _dispatch.trti2
lauum = _dispatch.lauum
lauu2 = _dispatch.lauu2
potri = _dispatch.potri
logdet = _dispatch.logdet
logdet_from_factor = _dispatch.logdet_from_factor
