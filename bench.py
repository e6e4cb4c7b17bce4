#!/usr/bin/env python
"""Time blocked f32 POTRF (``cholesky_tpu.potrf``) on one GPU.

    python bench.py [--n 16384] [--reps 5]

Prints the card's name and power limit (nvidia-smi) on stderr and ONE JSON
line on stdout:
  {"metric": "spotrf_gflops", "n", "value", "unit": "GFLOP/s",
   "time_ms", "resid", "device": {"platform", "kind", "count"}}

Flop count is the reference's n³/3 + n²/2 + n/6 (reference
test/lapack/cuspotrf.c:146-148); the time is the median of ``reps`` calls,
each waited for with ``jax.block_until_ready``. The factor is verified by
its backward residual max|LLᵀ−A|/max|A| (f64, on the card) before a
number is printed. Refuses to run when the first JAX device is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

RESID_TOL = 1e-5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (first JAX device is {dev.platform})",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi.splitlines()[0]}", file=sys.stderr)

    from cholesky_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    import cholesky_tpu as ct
    from chip_smoke import backward_residual, spd

    n = args.n
    A = spd(n, jnp.float32)
    f = jax.jit(lambda a: ct.potrf("L", a))
    t0 = time.perf_counter()
    F, info = jax.block_until_ready(f(A))
    print(f"compile+first run: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    resid = backward_residual(A, F)
    if int(info) != 0 or not resid <= RESID_TOL:
        print(f"bench: bad factor (info={int(info)}, resid={resid:.2e})",
              file=sys.stderr)
        return 1
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(A))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    flops = n ** 3 / 3 + n ** 2 / 2 + n / 6
    print(json.dumps({
        "metric": "spotrf_gflops", "n": n, "value": flops / dt / 1e9,
        "unit": "GFLOP/s", "time_ms": dt * 1e3, "resid": resid,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
