"""Error handling: pluggable hooks + argument validation.

Rebuild of the reference's L0 error layer:

- the reference's ``errorHandler`` global function-pointer hook
  (reference include/error.h:26-32, multigpu/error.c:4-11) becomes
  :func:`set_error_handler` — invoked for host-side runtime failures;
- the reference's LAPACK-style ``xerbla`` hook (reference blas/xerbla.c:5-9,
  include/blas.h:37-43) becomes :func:`set_xerbla` — invoked for invalid
  arguments detected at trace time.

Under ``jax.jit`` everything is traced once, so argument validation (shapes,
dtypes, flags — all static) happens at trace time and raises immediately;
*numerical* failure (non-positive-definite pivot, singular diagonal) cannot
abort a compiled program and is instead returned as a traced ``info`` value,
exactly like LAPACK's info codes (reference lapack/spotrf.c:47-51).
"""

from __future__ import annotations

import sys
from typing import Callable, Optional


def _default_error_handler(call: str, code: int, message: str,
                           function: str, location: str) -> None:
    # Same fields as the reference's default handler: call, code, string,
    # function, file:line (reference multigpu/error.c:4-11).
    print(f"error: {call} returned {code} ({message})\n"
          f"\tin {function} ({location})", file=sys.stderr)


def _default_xerbla(routine: str, arg: int, message: str = "") -> None:
    # Mirrors LAPACK's message format (reference blas/xerbla.c:5-8).
    print(f" ** On entry to {routine.upper()} parameter number {arg} "
          f"had an illegal value{': ' + message if message else ''}",
          file=sys.stderr)


_error_handler: Optional[Callable] = _default_error_handler
_xerbla: Optional[Callable] = _default_xerbla


def set_error_handler(handler: Optional[Callable]) -> Optional[Callable]:
    """Install a runtime-error hook; returns the previous one.

    ``None`` silences reporting (like setting the reference's
    ``errorHandler = NULL``).
    """
    global _error_handler
    prev, _error_handler = _error_handler, handler
    return prev


def set_xerbla(handler: Optional[Callable]) -> Optional[Callable]:
    """Install an invalid-argument hook; returns the previous one."""
    global _xerbla
    prev, _xerbla = _xerbla, handler
    return prev


def report_error(call: str, code: int, message: str, function: str,
                 location: str = "") -> None:
    if _error_handler is not None:
        _error_handler(call, code, message, function, location)


def xerbla(routine: str, arg: int, message: str = "") -> None:
    """Report an invalid argument and raise (trace-time analog of the
    reference's XERBLA macro, include/blas.h:37-43, which reports and
    returns the argument index)."""
    if _xerbla is not None:
        _xerbla(routine, arg, message)
    raise ValueError(
        f"{routine}: parameter {arg} had an illegal value"
        + (f": {message}" if message else ""))


def check(cond: bool, routine: str, arg: int, message: str = "") -> None:
    """Validate a static argument; on failure invoke xerbla and raise."""
    if not cond:
        xerbla(routine, arg, message)
