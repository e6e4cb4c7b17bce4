#!/usr/bin/env python
"""Benchmark + accuracy sweep suite with golden results, all four precisions.

Rebuild of the reference's sweep scripts and golden logs
(reference test/test_gpulapack.sh:4-13 — cuspotrf n=64..4096 step 64 etc.,
tee'd into the 51 text logs of test/benchmark_base.tar.gz): each sweep
point times the op on the device, checks max elementwise error against a
float64/complex128 numpy oracle with the eps-scaled analytic tolerance
(reference test/blas/sgemm.c:160-166), and emits one JSON line
  {"op", "config", "n", "time_ms", "gflops", "max_err", "tol", "passed"}.

Timing goes through utils.benchlib.bench_op (chained dependent iterations
inside ONE compiled program): per-op cost is then free of the per-call
dispatch overhead a naive dispatch loop measures.

Precisions (reference single2double.sh / complex2doublecomplex.sh tiers):
  --dtype s   float32 (default)
  --dtype d   float64 (native FP64; --backend ozaki for int8 slices)
  --dtype c/z complex64 / complex128, native.

Oracles run on host cores in parallel with device work via the native task
runtime (cholesky_tpu/runtime) — the reference's CPU/GPU overlap, repurposed.

Usage:
  python tools/sweep.py --ops potrf,potri --sizes 256:2048:256 \
      --out chiprun_out/sweep.jsonl
  python tools/sweep.py ... --golden chiprun_out/golden.jsonl     # compare
  python tools/sweep.py --dtype d --resume --out golden_d.jsonl   # accumulate
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from collections import deque
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class DT:
    """Per-letter dtype context (the s/d/c/z axis of the reference)."""

    def __init__(self, letter: str, backend: str = "auto"):
        assert letter in "sdcz"
        self.letter = letter
        self.real = letter in "sd"
        self.rdt = jnp.float32 if letter in "sc" else jnp.float64
        self.cdt = {"s": jnp.float32, "d": jnp.float64,
                    "c": jnp.complex64, "z": jnp.complex128}[letter]
        # complex operands as (re, im) pairs only for the embedding tier
        self.pair = (not self.real) and backend == "embed"
        # complex arithmetic = 4 real flops per multiply-add
        self.flop_factor = 1.0 if self.real else 4.0
        self.eps = EPS32 if letter in "sc" else EPS64
        # d on Ozaki int8 slices: the slice-split error model is wider
        # than native-f64 rounding
        self.fudge = 16.0 if (letter == "d" and backend == "ozaki") else 1.0

    # -- fixtures ----------------------------------------------------------

    def hpd(self, n, cond=100.0):
        from cholesky_tpu.rng import generators
        key = jax.random.PRNGKey(n)
        if self.pair:
            return generators.latmc_pair(key, n, cond, self.rdt)
        return generators.latmc(key, n, cond, self.cdt)

    def chol_factor(self, n, uplo="L"):
        from cholesky_tpu.ops import blocked
        # one jitted program: eager execution dispatches every XLA op
        # (and the potrf point at the same n warms this compile)
        F, _ = jax.jit(lambda a: blocked.potrf(uplo, a, backend="auto"))(
            self.hpd(n))
        return self._tri(F, uplo)

    def rand(self, n, seed_off=0):
        key = jax.random.PRNGKey(n + seed_off)
        k1, k2 = jax.random.split(key)
        r = (jax.random.uniform(k1, (n, n), self.rdt) - 0.5)
        if self.real:
            return r
        i = (jax.random.uniform(k2, (n, n), self.rdt) - 0.5)
        if self.pair:
            return r, i
        return jax.lax.complex(r, i).astype(self.cdt)

    # -- pair/array helpers ------------------------------------------------

    def _tril(self, X, k=0):
        if isinstance(X, tuple):
            return jnp.tril(X[0], k), jnp.tril(X[1], k)
        return jnp.tril(X, k)

    def _tri(self, X, uplo, k=0):
        if uplo == "L":
            return self._tril(X, k)
        if isinstance(X, tuple):
            return jnp.triu(X[0], k), jnp.triu(X[1], k)
        return jnp.triu(X, k)

    def trans_char(self):
        """The 'transposed' variant letter: conjugate-transpose for the
        complex tiers (the case the reference's c/z logs sweep)."""
        return "T" if self.real else "C"

    def to_np(self, X):
        """numpy f64/c128 view of an array or an (re, im) pair."""
        if isinstance(X, tuple):
            return (np.asarray(X[0], np.float64)
                    + 1j * np.asarray(X[1], np.float64))
        x = np.asarray(X)
        return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


#: optional global cap on bench_op chain length (--max-chain)
MAX_CHAIN = None


def _chain_for(n, letter):
    """bench_op chain length: long enough that the per-call dispatch and
    host-fetch overhead is amortized below the op's own runtime, short
    enough to keep each timed rep under ~1 s."""
    if n <= 256:
        c = 2048
    elif n <= 512:
        c = 1024
    elif n <= 1024:
        c = 512
    elif n <= 2048:
        c = 256
    elif n <= 4096:
        c = 128
    elif n <= 8192:
        c = 32
    else:
        c = 8
    if letter in ("d", "z"):
        c = max(16, c // 8)
    elif letter == "c":
        c = max(16, c // 2)
    if MAX_CHAIN is not None:
        c = min(c, MAX_CHAIN)
    return c


def _time(f, x, n, letter):
    """(median seconds/op, f(x)) — timing via the chained-program harness.
    The op value comes out of the SAME chained program (return_out): one
    compile per point instead of two."""
    from cholesky_tpu.utils.benchlib import bench_op
    return bench_op(f, x, chain=_chain_for(n, letter), reps=3,
                    return_out=True)


def _tol(dt: DT, fpe, scale, n=0):
    if dt.fudge > 1.0:
        # Ozaki tiers carry a slice-quantization floor (~2^-42 per
        # product) that does NOT shrink with the op's flop count — a
        # low-flop op like lauum (fpe=2n+3) would otherwise get a bound
        # below the representation floor of the int8-slice arithmetic
        fpe = max(fpe, 60 * n)
    return fpe * 2.0 * dt.eps * dt.fudge * max(1.0, scale)


# --- per-op sweep points: return (dt_sec, flops, oracle, fpe, info) --------
#
# Every point takes a variant ``cfg`` (the reference
# sweeps upper AND lower per LAPACK routine, test/test_gpulapack.sh:4-13,
# and per-combo trmm2/trsm logs whose FAILED segments were variant-
# specific).  Encodings:
#   potrf/potri/lauum/logdet: "l" | "u"            (uplo)
#   trtri:                    "ln"|"un"|"lu"|"uu"  (uplo, diag)
#   gemm:                     "nn"|"nt"|"tn"|"tt"  (transa, transb)
#   syrk:                     "ln"|"lt"|"un"|"ut"  (uplo, trans)
#   trmm/trsm:                "llnn" …             (side, uplo, transa, diag)
# For complex tiers a "t" position means the conjugate transpose.

def point_potrf(n, backend, dt: DT, cfg="l"):
    from cholesky_tpu.ops import blocked
    uplo = cfg.upper()
    tri = np.tril if uplo == "L" else np.triu
    A = dt.hpd(n)
    f = jax.jit(lambda a: blocked.potrf(uplo, a, backend=backend))
    sec, (F, info) = _time(f, A, n, dt.letter)
    Fnp = tri(dt.to_np(dt._tri(F, uplo)))
    Anp = dt.to_np(A)

    def oracle():
        ref = np.linalg.cholesky(Anp)
        if uplo == "U":
            ref = ref.conj().T
        return float(np.max(np.abs(Fnp - ref))), float(np.max(np.abs(ref)))

    # fpe carries the fixture's cond=100 forward-error amplification: the
    # oracle is exact-f64 Cholesky, so |impl - ref| ~ kappa * eps * n unlike
    # the reference's same-precision naive-ref comparison where the
    # conditioning error largely cancels (test/lapack/cuspotrf.c:106-114)
    return sec, dt.flop_factor * (n ** 3 / 3 + n ** 2 / 2), oracle, 100 * n, int(info)


def point_potri(n, backend, dt: DT, cfg="l"):
    from cholesky_tpu.ops import blocked
    uplo = cfg.upper()
    tri = np.tril if uplo == "L" else np.triu
    F = dt.chol_factor(n, uplo)
    f = jax.jit(lambda a: blocked.potri(uplo, a, backend=backend))
    sec, (Inv, info) = _time(f, F, n, dt.letter)
    Invnp = tri(dt.to_np(dt._tri(Inv, uplo)))
    Fnp = tri(dt.to_np(F))
    Anp = Fnp @ Fnp.conj().T if uplo == "L" else Fnp.conj().T @ Fnp

    def oracle():
        ref = tri(np.linalg.inv(Anp))
        return float(np.max(np.abs(Invnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * 2 * n ** 3 / 3, oracle, 3000 * n, int(info)


def point_trtri(n, backend, dt: DT, cfg="ln"):
    from cholesky_tpu.ops import blocked
    uplo, diag = cfg[0].upper(), cfg[1].upper()
    tri = np.tril if uplo == "L" else np.triu
    A = dt.chol_factor(n, uplo)
    f = jax.jit(lambda a: blocked.trtri(uplo, diag, a, backend=backend))
    sec, (R, info) = _time(f, A, n, dt.letter)
    k = -1 if uplo == "L" else 1
    Rnp = dt.to_np(dt._tri(R, uplo))
    Anp = tri(dt.to_np(A))
    if diag == "U":
        # unit-diag contract: only the strict triangle of the output is
        # defined (diagonal passes through untouched)
        Rnp = tri(Rnp, k)

    def oracle():
        T = Anp.copy()
        if diag == "U":
            np.fill_diagonal(T, 1.0)
        ref = tri(np.linalg.inv(T))
        if diag == "U":
            ref = tri(ref, k)
        else:
            ref = tri(ref)
        return float(np.max(np.abs(tri(Rnp) - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * n ** 3 / 3, oracle, 60 * n, int(info)


def point_lauum(n, backend, dt: DT, cfg="l"):
    from cholesky_tpu.ops import blocked
    uplo = cfg.upper()
    tri = np.tril if uplo == "L" else np.triu
    A = dt.chol_factor(n, uplo)
    f = jax.jit(lambda a: blocked.lauum(uplo, a, backend=backend))
    sec, R = _time(f, A, n, dt.letter)
    Rnp = tri(dt.to_np(dt._tri(R, uplo)))
    Anp = tri(dt.to_np(A))

    def oracle():
        # LAPACK xLAUUM: uplo=L -> Lᴴ·L, uplo=U -> U·Uᴴ
        ref = tri(Anp.conj().T @ Anp if uplo == "L" else Anp @ Anp.conj().T)
        return float(np.max(np.abs(Rnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * n ** 3 / 3, oracle, 2 * n + 3, 0


def point_logdet(n, backend, dt: DT, cfg="l"):
    from cholesky_tpu.ops import blocked
    uplo = cfg.upper()
    A = dt.hpd(n, cond=30.0)
    f = jax.jit(lambda a: blocked.logdet(uplo, a, backend=backend))
    sec, (val, info) = _time(f, A, n, dt.letter)
    Anp = dt.to_np(A)
    v = float(np.asarray(val))

    def oracle():
        _, ref = np.linalg.slogdet(Anp)
        return float(abs(v - ref)), float(abs(ref))

    return sec, dt.flop_factor * n ** 3 / 3, oracle, 60 * n, int(info)


def point_logdet_diag(n, backend, dt: DT, cfg="auto"):
    """Bandwidth-metric logdet from a factored diagonal, to n = 2^20 —
    the reference's cuslogdet sweep (test/benchmark_base cuslogdet.txt,
    strided-vector entry slogdet.c:10-25). 'gflops' field = GB/s here."""
    from cholesky_tpu.ops import lapack_ref
    d = (jax.random.uniform(jax.random.PRNGKey(n), (n,), dt.rdt) + 0.5)
    f = jax.jit(lapack_ref.logdet_from_factor)
    sec, val = _time(f, d, min(n, 8192), dt.letter)
    dn = np.asarray(d, np.float64)
    v = float(np.asarray(val))

    def oracle():
        ref = 2.0 * float(np.sum(np.log(dn)))
        return float(abs(v - ref)), float(abs(ref))

    # report bytes moved (one read of the vector) — bandwidth, not flops
    nbytes = n * np.dtype(np.float32 if dt.letter in "sc" else np.float64).itemsize
    return sec, nbytes, oracle, 60 * max(1, n // 1024), 0


def point_gemm(n, backend, dt: DT, cfg="nn"):
    from cholesky_tpu.ops import blocked
    ta = "N" if cfg[0] == "n" else dt.trans_char()
    tb = "N" if cfg[1] == "n" else dt.trans_char()
    A, B, C = dt.rand(n, 0), dt.rand(n, 1), dt.rand(n, 2)
    # operands travel as jit ARGUMENTS, not closures: a closed-over device
    # array is inlined into the HLO as a literal (2x134 MB at n=4096 f64)
    f = jax.jit(lambda abc: blocked.gemm(ta, tb, 1.0, abc[0], abc[1],
                                         -1.0, abc[2], backend=backend))
    sec, D = _time(f, (A, B, C), n, dt.letter)
    Dnp = dt.to_np(D)
    An, Bn, Cn = dt.to_np(A), dt.to_np(B), dt.to_np(C)

    def _op(M, t):
        return M if t == "N" else (M.T if t == "T" else M.conj().T)

    def oracle():
        ref = _op(An, ta) @ _op(Bn, tb) - Cn
        return float(np.max(np.abs(Dnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * 2 * n ** 3, oracle, 2 * n + 3, 0


def point_gemm_k(k, backend, dt: DT, cfg="nn"):
    """Rectangular GEMM with m = n = 1024 fixed and the contraction dim
    swept via the sizes axis — the reference's k-sweeps
    (reference test/test_gpublas.sh:5-25, cusgemm_*.txt logs)."""
    from cholesky_tpu.ops import blocked
    M = 1024
    ta = "N" if cfg[0] == "n" else dt.trans_char()
    tb = "N" if cfg[1] == "n" else dt.trans_char()

    def rect(rows, cols, off):
        key = jax.random.PRNGKey(rows * 7 + cols * 13 + off)
        k1, k2 = jax.random.split(key)
        r = jax.random.uniform(k1, (rows, cols), dt.rdt) - 0.5
        if dt.real:
            return r
        i = jax.random.uniform(k2, (rows, cols), dt.rdt) - 0.5
        return (r, i) if dt.pair else jax.lax.complex(r, i).astype(dt.cdt)

    A = rect(M, k, 0) if ta == "N" else rect(k, M, 0)
    B = rect(k, M, 1) if tb == "N" else rect(M, k, 1)
    C = rect(M, M, 2)
    f = jax.jit(lambda abc: blocked.gemm(ta, tb, 1.0, abc[0], abc[1],
                                         -1.0, abc[2], backend=backend))
    sec, D = _time(f, (A, B, C), max(k, 256), dt.letter)
    Dnp = dt.to_np(D)
    An, Bn, Cn = dt.to_np(A), dt.to_np(B), dt.to_np(C)

    def _op(Mx, t):
        return Mx if t == "N" else (Mx.T if t == "T" else Mx.conj().T)

    def oracle():
        ref = _op(An, ta) @ _op(Bn, tb) - Cn
        return float(np.max(np.abs(Dnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * 2 * M * M * k, oracle, 2 * k + 3, 0


def point_syrk(n, backend, dt: DT, cfg="ln"):
    from cholesky_tpu.ops import blocked
    uplo = cfg[0].upper()
    trans = "N" if cfg[1] == "n" else dt.trans_char()
    tri = np.tril if uplo == "L" else np.triu
    A, C = dt.rand(n, 0), dt.rand(n, 1)
    if dt.real:
        f = jax.jit(lambda ac: blocked.syrk(uplo, trans, -1.0, ac[0], 1.0,
                                            ac[1], backend=backend))
        sec, D = _time(f, (A, C), n, dt.letter)
    else:
        # complex tier: the Hermitian rank-k update is HERK
        Ch = dt._tri(C, uplo)  # only the triangle is read; diag im ignored
        f = jax.jit(lambda ac: blocked.herk(uplo, trans, -1.0, ac[0], 1.0,
                                            ac[1], backend=backend))
        sec, D = _time(f, (A, Ch), n, dt.letter)
    Dnp = tri(dt.to_np(dt._tri(D, uplo)))
    An = dt.to_np(A)
    Cn = tri(dt.to_np(dt._tri(C, uplo) if not dt.real else C))
    if not dt.real:
        Cn = Cn - 1j * np.diag(np.diag(Cn).imag)

    def oracle():
        if dt.real:
            P = An @ An.T if trans == "N" else An.T @ An
        else:
            P = An @ An.conj().T if trans == "N" else An.conj().T @ An
        ref = tri(-P + Cn)
        return float(np.max(np.abs(Dnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * n ** 3, oracle, 2 * n + 3, 0


def _trimat(dt: DT, An, uplo, diag, transa):
    """numpy op(tri(A)) for a trmm/trsm variant."""
    T = np.tril(An) if uplo == "L" else np.triu(An)
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    if transa == "T":
        T = T.T
    elif transa == "C":
        T = T.conj().T
    return T


def point_trmm(n, backend, dt: DT, cfg="llnn"):
    from cholesky_tpu.ops import blocked
    side, uplo, diag = cfg[0].upper(), cfg[1].upper(), cfg[3].upper()
    transa = "N" if cfg[2] == "n" else dt.trans_char()
    A = dt.chol_factor(n, uplo)
    B = dt.rand(n, 1)
    # B first in the pytree: bench_op perturbs the first leaf, and B feeds
    # the matmuls every iteration (bench-op-hoisting discipline)
    f = jax.jit(lambda ba: blocked.trmm(side, uplo, transa, diag, 1.0,
                                        ba[1], ba[0], backend=backend))
    sec, D = _time(f, (B, A), n, dt.letter)
    Dnp = dt.to_np(D)
    An = dt.to_np(A)
    Bn = dt.to_np(B)

    def oracle():
        T = _trimat(dt, An, uplo, diag, transa)
        ref = T @ Bn if side == "L" else Bn @ T
        return float(np.max(np.abs(Dnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * n ** 3, oracle, 2 * n + 3, 0


def point_trsm(n, backend, dt: DT, cfg="llnn"):
    from cholesky_tpu.ops import blocked
    side, uplo, diag = cfg[0].upper(), cfg[1].upper(), cfg[3].upper()
    transa = "N" if cfg[2] == "n" else dt.trans_char()
    A = dt.chol_factor(n, uplo)
    B = dt.rand(n, 1)
    f = jax.jit(lambda ba: blocked.trsm(side, uplo, transa, diag, 1.0,
                                        ba[1], ba[0], backend=backend))
    sec, X = _time(f, (B, A), n, dt.letter)
    Xnp = dt.to_np(X)
    An = dt.to_np(A)
    Bn = dt.to_np(B)

    def oracle():
        # scaled residual — forward error is cond-limited for triangular
        # solves (reference custrsm tests use ≤1e-6 on tame inputs)
        T = _trimat(dt, An, uplo, diag, transa)
        res = np.max(np.abs((T @ Xnp if side == "L" else Xnp @ T) - Bn))
        scale = np.max(np.abs(Xnp)) * np.max(np.abs(T))
        return float(res / max(scale, 1e-30)), 1.0

    return sec, dt.flop_factor * n ** 3, oracle, 60 * n, 0


POINTS = {
    "potrf": point_potrf, "potri": point_potri, "trtri": point_trtri,
    "lauum": point_lauum, "logdet": point_logdet,
    "logdet_diag": point_logdet_diag,
    "gemm": point_gemm, "gemm_k": point_gemm_k, "syrk": point_syrk,
    "trmm": point_trmm, "trsm": point_trsm,
}

#: the variant a bare sweep records (and what pre-r4 golden rows with
#: config="auto" measured)
DEFAULT_CFG = {
    "potrf": "l", "potri": "l", "trtri": "ln", "lauum": "l", "logdet": "l",
    "logdet_diag": "auto", "gemm": "nn", "gemm_k": "nn", "syrk": "ln",
    "trmm": "llnn", "trsm": "llnn",
}

#: --config grid: the per-op recommended variant set (reference bar:
#: test_gpulapack.sh sweeps u AND l per routine; custrmm2_*/custrsm_* logs
#: cover the side/uplo/trans grid)
GRID_CFG = {
    "potrf": ["l", "u"], "potri": ["l", "u"],
    "trtri": ["ln", "un", "lu", "uu"],
    "lauum": ["l", "u"], "logdet": ["l", "u"], "logdet_diag": ["auto"],
    "gemm": ["nn", "nt", "tn", "tt"],
    "gemm_k": ["nn", "nt", "tn", "tt"],
    "syrk": ["ln", "lt", "un", "ut"],
    "trmm": ["llnn", "lltn", "lunn", "lutn",
             "rlnn", "rltn", "runn", "rutn"],
    "trsm": ["llnn", "lltn", "lunn", "lutn",
             "rlnn", "rltn", "runn", "rutn"],
}


def norm_cfg(op: str, cfg: str | None) -> str:
    """Map a recorded config to a variant key.  Pre-round-4 rows stored the
    BACKEND in "config" (always "auto"); those measured the default
    variant."""
    if cfg in GRID_CFG.get(op, ()):
        return cfg
    return DEFAULT_CFG.get(op, "auto")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", default="potrf,potri,trtri,lauum,logdet,gemm,syrk,trmm,trsm")
    ap.add_argument("--sizes", default="256:2048:256",
                    help="start:stop:step (inclusive stop), or comma list")
    ap.add_argument("--dtype", default="s", choices=list("sdcz"))
    ap.add_argument("--backend", default=None,
                    help="default: auto; ref / xla / ozaki / embed")
    ap.add_argument("--config", default="default",
                    help="variant axis: 'default' (one variant per op), "
                         "'grid' (the per-op GRID_CFG set), or a comma "
                         "list like 'l,u' / 'llnn,rutn' applied to every "
                         "selected op")
    ap.add_argument("--out", default="chiprun_out/sweep.jsonl")
    ap.add_argument("--golden", default=None,
                    help="compare gflops against a golden jsonl (±30%%)")
    ap.add_argument("--resume", action="store_true",
                    help="append to --out, skipping points already present")
    ap.add_argument("--max-chain", type=int, default=None,
                    help="cap the chained-iteration count (CPU smokes, "
                         "very large sizes)")
    ap.add_argument("--cpu", action="store_true",
                    help="pin the host-CPU platform (smoke runs without a "
                         "GPU)")
    args = ap.parse_args()

    from cholesky_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.max_chain is not None:
        global MAX_CHAIN
        MAX_CHAIN = args.max_chain
    if args.dtype in "dz":
        jax.config.update("jax_enable_x64", True)

    backend = args.backend or "auto"
    dt = DT(args.dtype, backend)
    if ":" in args.sizes:
        start, stop, step = (int(x) for x in args.sizes.split(":"))
        sizes = list(range(start, stop + 1, step))
    else:
        sizes = [int(x) for x in args.sizes.split(",")]
    ops = args.ops.split(",")

    from cholesky_tpu.runtime import TaskPool

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    def cfgs_for(op):
        if args.config == "default":
            return [DEFAULT_CFG[op]]
        if args.config == "grid":
            return GRID_CFG[op]
        want = [c.strip() for c in args.config.split(",") if c.strip()]
        return [c for c in want if c in GRID_CFG.get(op, ())] or \
            [DEFAULT_CFG[op]]

    done = set()
    results = []
    if args.resume and out_path.exists():
        with open(out_path) as f:
            for line in f:
                r = json.loads(line)
                results.append(r)
                done.add((r["op"], r.get("dtype", "s"),
                          norm_cfg(r["op"], r.get("config")), r["n"]))

    fresh = []

    def flush():
        # Snapshot resumed + finalized rows after EVERY completed point:
        # deadline-killed chunks keep what they measured (the 21:18 r5 d
        # sweep lost 4 points ≈ 40 chip-minutes to the old exit-only write).
        tmp = out_path.with_suffix(out_path.suffix + ".tmp")
        with open(tmp, "w") as f:
            for rec in results + fresh:
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, out_path)

    def finalize(rec, holder, t, fpe):
        t.join()
        tol = _tol(dt, fpe, holder["scale"], rec["n"])
        rec["max_err"] = float(f"{holder['err']:.3e}")
        rec["tol"] = float(f"{tol:.3e}")
        rec["passed"] = bool(holder["err"] <= tol and rec["info"] == 0)
        fresh.append(rec)
        flush()

    with TaskPool(4) as pool:
        oracle_tasks = deque()
        for op in ops:
            for cfg in cfgs_for(op):
                for n in sizes:
                    if (op, dt.letter, cfg, n) in done:
                        continue
                    try:
                        sec, flops, oracle, fpe, info = \
                            POINTS[op](n, backend, dt, cfg)
                    except Exception as e:
                        log(f"{op}[{dt.letter}/{cfg}] n={n}: FAILED "
                            f"{type(e).__name__}: {str(e)[:150]}")
                        fresh.append({"op": op, "dtype": dt.letter,
                                      "config": cfg, "backend": backend,
                                      "n": n, "passed": False,
                                      "error": f"{type(e).__name__}"})
                        flush()
                        continue
                    rec = {"op": op, "dtype": dt.letter, "config": cfg,
                           "backend": backend, "n": n,
                           "time_ms": round(sec * 1e3, 3),
                           "gflops": round(flops / sec / 1e9, 1),
                           "info": info}
                    holder = {}

                    def run_oracle(oracle=oracle, holder=holder):
                        err, scale = oracle()
                        holder["scale"] = scale
                        holder["err"] = err  # "err" in holder == done
                        return 0

                    t = pool.run(len(oracle_tasks) % 4, run_oracle)
                    oracle_tasks.append((rec, holder, t, fpe))
                    log(f"{op}[{dt.letter}/{cfg}] n={n}: {rec['gflops']} "
                        f"GF/s ({rec['time_ms']} ms)")
                    # Drain already-verified oracles in order so their rows
                    # hit disk while later points are still measuring.
                    while oracle_tasks and "err" in oracle_tasks[0][1]:
                        finalize(*oracle_tasks.popleft())
        while oracle_tasks:
            finalize(*oracle_tasks.popleft())

    results.extend(fresh)
    with open(out_path, "w") as f:
        for rec in results:
            f.write(json.dumps(rec) + "\n")
    scored = [r for r in results if "max_err" in r or not r["passed"]]
    npass = sum(r["passed"] for r in scored)
    log(f"{npass}/{len(scored)} PASSED -> {out_path}")

    if args.golden:
        golden = {}
        with open(args.golden) as f:
            for line in f:
                g = json.loads(line)
                golden[(g["op"], g.get("dtype", "s"),
                        norm_cfg(g["op"], g.get("config")), g["n"])] = g
        regressions = []
        for r in results:
            g = golden.get((r["op"], r.get("dtype", "s"),
                            norm_cfg(r["op"], r.get("config")), r["n"]))
            if g and "gflops" in r and r["gflops"] < 0.7 * g["gflops"]:
                regressions.append((r["op"], r["n"], r["gflops"], g["gflops"]))
        if regressions:
            log("PERF REGRESSIONS (>30% below golden):")
            for op, n, got, want in regressions:
                log(f"  {op} n={n}: {got} vs golden {want} GF/s")
            sys.exit(1)
        log("no perf regressions vs golden")

    sys.exit(0 if npass == len(scored) else 2)


if __name__ == "__main__":
    main()
