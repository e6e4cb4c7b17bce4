#!/usr/bin/env python
"""Time the tile layer's plain-XLA building blocks on one GPU.

    python tools/layer_times.py [--out chiprun_out/layer_times.jsonl]

Each measurement is the median of ``--reps`` calls after one warm-up call
(whose time, compilation included, is reported as ``first_s``), each
waited for with ``jax.block_until_ready``. One JSON line per measurement
goes to stdout and to ``--out``; the card's name and power limit
(nvidia-smi) come first. Measured:

  mm / syrk_ln / trmm     f32 tile products at 8192 (HIGHEST: FP32, no TF32)
  potrf leaf              potrf at n=16384 with the device-solver leaf
                          (cuSOLVER potrf + cuBLAS trsm, sweep rescue) and
                          with the oracle column-sweep leaf, nb = 128, 256
  cusolver                lax.linalg.cholesky at n=16384 (one library call)
  ozaki                   int8-slice f64 matmul at 4096³ vs native f64

Refuses to run when the first JAX device is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/layer_times.jsonl")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"layer_times: no GPU (first JAX device is {dev.platform})",
              file=sys.stderr)
        return 1
    from cholesky_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    from cholesky_tpu.ops import blocked, lapack_ref, ozaki
    from chip_smoke import spd

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    out = open(args.out, "w")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    emit({"card": card, "kind": dev.device_kind})

    def measure(name, f, *operands, flops=None, **meta):
        f = jax.jit(f)
        t0 = time.perf_counter()
        jax.block_until_ready(f(*operands))
        first = time.perf_counter() - t0
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*operands))
            times.append(time.perf_counter() - t0)
        t = statistics.median(times)
        row = {"name": name, "ms": t * 1e3, "first_s": first,
               "spread_ms": (max(times) - min(times)) * 1e3, **meta}
        if flops:
            row["tflops"] = flops / t / 1e12
        emit(row)

    key = jax.random.PRNGKey(0)
    n = 8192
    T32 = blocked._XlaTiles(jnp.float32)
    A = jax.random.normal(key, (n, n), jnp.float32)
    B = jax.random.normal(jax.random.PRNGKey(1), (n, n), jnp.float32)
    measure("mm_f32", lambda a, b: T32.mm(a, b), A, B, flops=2 * n ** 3,
            n=n)
    measure("syrk_ln_f32", lambda a, c: T32.syrk_ln(-1.0, a, 1.0, c), A, B,
            flops=n ** 3, n=n, k=n, note="flops counted as n^2 k (triangle)")
    L = jnp.tril(A)
    measure("trmm_f32", lambda l, b: blocked._trmm_left_tiles(
        T32, l, "L", "N", b, 1.0), L, B, flops=n ** 3, n=n,
        note="flops counted as n^3 (triangle)")
    del A, B, L

    class SweepTiles(blocked._XlaTiles):
        """The oracle column-sweep leaves (lapack_ref), for comparison."""

        def potf2(self, A):
            F, info = lapack_ref.potf2("L", jnp.tril(A))
            return jnp.tril(F), info

        def trti2(self, A, *, unit=False):
            T, info = lapack_ref.trti2("L", "U" if unit else "N", A)
            return jnp.tril(T), info

    nf = 16384
    flops = nf ** 3 / 3
    for dtype in (jnp.float32, jnp.float64):
        S = spd(nf, dtype)
        name = jnp.dtype(dtype).name
        for nb in (128, 256):
            for leaf, cls in (("cusolver", blocked._XlaTiles),
                              ("sweep", SweepTiles)):
                if leaf == "sweep" and dtype == jnp.float64:
                    continue
                t = cls(dtype)
                measure(f"potrf_{leaf}_leaf_{name}",
                        lambda a, t=t, nb=nb: blocked._potrf_lower(a, t, nb),
                        S, flops=flops, n=nf, nb=nb)
        measure(f"cusolver_cholesky_{name}",
                lambda a: jax.lax.linalg.cholesky(a, symmetrize_input=False),
                S, flops=flops, n=nf)
        del S

    no = 4096
    A = jax.random.normal(key, (no, no), jnp.float64)
    B = jax.random.normal(jax.random.PRNGKey(1), (no, no), jnp.float64)
    measure("mm_f64_native", lambda a, b: blocked._XlaTiles(jnp.float64).mm(
        a, b), A, B, flops=2 * no ** 3, n=no)
    measure("mm_f64_ozaki_s6", lambda a, b: ozaki.matmul_f64(a, b, slices=6),
            A, B, flops=2 * no ** 3, n=no)
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
