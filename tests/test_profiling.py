"""Trace helper contract (SURVEY §5: jax.profiler is the JAX analog
of the reference's in-test CUevent timing, test/lapack/cuspotrf.c:129-141).

The helpers must (a) actually produce a trace artifact around a jitted
dispatch, and (b) be zero-cost no-ops when no trace is active — annotate()
is placed around hot driver steps so it must never require an open trace.
"""

import os

import jax
import jax.numpy as jnp

from cholesky_tpu.utils import profiling


def test_trace_writes_artifact(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("matmul-under-trace"):
            x = jnp.ones((64, 64), jnp.float32)
            y = jax.jit(lambda a: a @ a)(x)
            jax.block_until_ready(y)
    # jax writes plugins/profile/<timestamp>/*.xplane.pb under the logdir
    found = [os.path.join(r, f)
             for r, _, fs in os.walk(logdir) for f in fs]
    assert found, f"no trace artifacts written under {logdir}"


def test_annotate_is_standalone_noop():
    with profiling.annotate("no-active-trace"):
        x = jnp.ones((8, 8), jnp.float32)
        jax.block_until_ready(x * 2)


def test_annotate_function_preserves_value():
    fn = profiling.annotate_function(lambda a: a + 1, name="inc")
    out = fn(jnp.float32(41.0))
    assert float(out) == 42.0
