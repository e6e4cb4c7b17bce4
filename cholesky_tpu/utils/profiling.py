"""Tracing/profiling helpers (SURVEY §5: the reference keeps timing in its
test binaries — CUevent loops, test/lapack/cuspotrf.c:129-141 — and has no
in-library profiler; the JAX equivalent named there is ``jax.profiler``
traces plus the benchmark harness in ``benchlib``).

This module is the trace side of that pair: a context manager that wraps
``jax.profiler.trace`` with forced completion inside the traced region,
plus named sub-annotations that show up as spans in the trace viewer. On
the GPU the trace holds the device's own kernel timeline beside the host
spans.
"""

from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``jax.profiler`` trace of the enclosed block into ``logdir``.

    Forces completion of all outstanding device work at block exit (via
    ``jax.effects_barrier``) so asynchronously-dispatched work launched
    inside the block is actually inside the trace window.

    Usage::

        with profiling.trace("/tmp/trace"):
            L, info = potrf("L", A)
            jax.block_until_ready(L)
    """
    os.makedirs(logdir, exist_ok=True)
    with jax.profiler.trace(logdir):
        try:
            yield logdir
        finally:
            jax.effects_barrier()


def annotate(name: str):
    """Named span context manager: nests inside :func:`trace` and appears
    as a labeled region in the trace viewer. Usable around dispatch sites
    (driver steps, sweep points); zero-cost when no trace is active."""
    return jax.profiler.TraceAnnotation(name)


def annotate_function(fn, name: str | None = None):
    """Wrap ``fn`` so every call is a named span (module-level analog of
    :func:`annotate` for hot drivers)."""
    return jax.profiler.annotate_function(fn, name=name)
