#!/usr/bin/env python
"""GPU smoke test: the library's main path once, at full size, on one card.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the distributed tier only

Phases (one line each, with its numbers, timing and tolerance):

  device    the first JAX device is a GPU; its kind, and the card's name and
            power limit from nvidia-smi
  factor    potrf at n=16384 (f32, f64): info, backward residual computed in
            f64 on the card, elementwise agreement with lax.linalg.cholesky
            (cuSOLVER) and, at n=4096, with the oracle tier lapack_ref.potrf
  solve     trsm (L,L,N,N and L,L,T,N, 64 right-hand sides), potri, logdet,
            trtri, lauum at n=8192 (f32, f64) against the oracle tier
  complex   cpotrf / zpotrf at n=4096 on native c64 / c128 against the oracle
  gp        one GP hyperparameter step (models/gp.py) at n=16384, d=8: f64
            against the same step on backend='ref', f32 against f64; then the
            __graft_entry__ forward step
  four-cards  (--four-cards only) block-cyclic potrf_sharded at n=32768 in f64
            and the distributed GP step (dp=1 x mp=4, n_train=8192) against
            the single-card drivers, with each card's peak bytes in use

f32 products run at HIGHEST precision — plain FP32, no TF32, which would
fail these bounds. Elementwise tolerances are tests/util.tol(dtype, n),
the eps-scaled analytic bound of the test suite.

Exits non-zero, printing no result, when the first device is not a GPU or
any check fails. The last line of a passing run is the JSON object
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

N_FACTOR = 16384
N_ORACLE = 4096
N_SOLVE = 8192
NRHS = 64
N_COMPLEX = 4096
N_GP, D_GP = 16384, 8
N_DIST = 32768
N_GP_DIST, NB_GP_DIST = 8192, 256
COND = 100.0
#: block size of the oracle tier's left-looking potrf: its block loop is
#: unrolled at trace time, so wider blocks mean fewer steps to compile
ORACLE_NB = 256

RESID_TOL = {"float32": 1e-5, "float64": 1e-12}
GP_F64_RTOL = 1e-8
GP_F32_NLL_RTOL = 1e-3

FAILURES: list[str] = []


def log(line: str) -> None:
    print(line, flush=True)


def check(what: str, value: float, bound: float) -> str:
    """Record a failed check; returns 'value<=bound' for the phase line."""
    ok = value <= bound     # False for NaN too
    if not ok:
        FAILURES.append(f"{what}: {value:.3e} > {bound:.3e}")
    return f"{what}={value:.3e}{'<=' if ok else '>'}{bound:.1e}"


# --------------------------------------------------------------------------
# numerics, computed on the device in the widest dtype
# --------------------------------------------------------------------------

def backward_residual(A, F):
    """max|L·Lᴴ − A| / max|A| with L = tril(F), in f64/c128."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def r(A, F):
        wide = jnp.promote_types(A.dtype, jnp.float64)
        L = jnp.tril(F).astype(wide)
        Aw = A.astype(wide)
        R = jnp.matmul(L, L.conj().T, precision=lax.Precision.HIGHEST) - Aw
        return jnp.max(jnp.abs(R)) / jnp.max(jnp.abs(Aw))

    return float(r(A, F))


def elementwise(X, ref):
    """(max|X − ref|, max|ref|) in the widest dtype, for tests/util.tol."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def d(X, ref):
        wide = jnp.promote_types(ref.dtype, jnp.float64)
        Xw, Rw = X.astype(wide), ref.astype(wide)
        return jnp.max(jnp.abs(Xw - Rw)), jnp.max(jnp.abs(Rw))

    diff, scale = d(X, ref)
    return float(diff), float(scale)


@functools.cache
def _test_util():
    """tests/util.py of this checkout, loaded by path: an installed
    package named ``tests`` must not shadow it."""
    path = Path(__file__).resolve().parent / "tests" / "util.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_util", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tol(dtype, n, scale):
    """tests/util.tol: the suite's eps-scaled analytic bound."""
    return _test_util().tol(dtype, n, scale)


def _tol_pair(X, ref, dtype, n):
    """(max|X − ref|, tol(dtype, n, max|ref|)) for check()."""
    diff, scale = elementwise(X, ref)
    return diff, tol(dtype, n, scale)


def timed(f, *args):
    """(result, seconds) of one call, waited for with block_until_ready."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*args))
    return out, time.perf_counter() - t0


def spd(n, dtype, seed=0):
    import jax
    from cholesky_tpu.rng import latmc
    return jax.block_until_ready(
        jax.jit(latmc, static_argnums=(1, 2, 3))(
            jax.random.PRNGKey(seed), n, COND, dtype))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device():
    """The first JAX device must be a GPU; returns it. Prints the card's
    name and power limit as nvidia-smi reports them."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (first JAX device is "
                         f"{dev.platform}: {dev.device_kind})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(f"device: kind={dev.device_kind} count={len(jax.devices())} "
        f"nvidia-smi: {smi[0]}")
    return dev


def phase_factor(n=N_FACTOR, n_oracle=N_ORACLE):
    import jax
    import jax.numpy as jnp
    import cholesky_tpu as ct
    from cholesky_tpu.ops import lapack_ref

    potrf = jax.jit(lambda a: ct.potrf("L", a))
    chol = jax.jit(lambda a: jax.lax.linalg.cholesky(a))
    oracle = jax.jit(lambda a: lapack_ref.potrf("L", a, ORACLE_NB))
    for dtype in (jnp.float32, jnp.float64):
        name = jnp.dtype(dtype).name
        A = spd(n, dtype)
        (F, info), t_first = timed(potrf, A)
        (F, info), t_run = timed(potrf, A)
        parts = [check("info", abs(int(info)), 0)]
        parts.append(check("resid", backward_residual(A, F),
                           RESID_TOL[name]))
        Lc, t_chol = timed(chol, A)
        Lc, t_chol = timed(chol, A)
        parts.append(check("vs_cusolver", *_tol_pair(jnp.tril(F), Lc,
                                                      dtype, n)))
        del A, F, Lc
        Ao = spd(n_oracle, dtype, seed=1)
        Fo, _ = potrf(Ao)
        Lo, info_o = oracle(Ao)
        parts.append(check(f"vs_oracle@{n_oracle}",
                           *_tol_pair(jnp.tril(Fo), jnp.tril(Lo), dtype,
                                      n_oracle)))
        prec = "HIGHEST(FP32,no-TF32)" if name == "float32" else "FP64"
        log(f"factor[{name}] n={n} precision={prec} "
            f"{' '.join(parts)} t_first={t_first:.2f}s "
            f"t_potrf={t_run * 1e3:.1f}ms t_cusolver={t_chol * 1e3:.1f}ms")


def phase_solve(n=N_SOLVE, nrhs=NRHS):
    import jax
    import jax.numpy as jnp
    import cholesky_tpu as ct
    from cholesky_tpu.ops import blas_ref, lapack_ref

    ops = {
        "trsm_llnn": (lambda F, B: ct.trsm("L", "L", "N", "N", 1.0, F, B),
                      lambda F, B: blas_ref.trsm("L", "L", "N", "N", 1.0,
                                                 F, B)),
        "trsm_lltn": (lambda F, B: ct.trsm("L", "L", "T", "N", 1.0, F, B),
                      lambda F, B: blas_ref.trsm("L", "L", "T", "N", 1.0,
                                                 F, B)),
        "potri": (lambda F, B: jnp.tril(ct.potri("L", F)[0]),
                  lambda F, B: jnp.tril(lapack_ref.potri("L", F)[0])),
        "trtri": (lambda F, B: jnp.tril(ct.trtri("L", "N", F)[0]),
                  lambda F, B: jnp.tril(lapack_ref.trtri("L", "N", F)[0])),
        "lauum": (lambda F, B: jnp.tril(ct.lauum("L", F)),
                  lambda F, B: jnp.tril(lapack_ref.lauum("L", F))),
    }
    for dtype in (jnp.float32, jnp.float64):
        name = jnp.dtype(dtype).name
        A = spd(n, dtype, seed=2)
        F = jnp.tril(jax.jit(lambda a: ct.potrf("L", a))(A)[0])
        B = jax.random.normal(jax.random.PRNGKey(3), (n, nrhs), dtype)
        parts, t0 = [], time.perf_counter()
        for op, (fast, ref) in ops.items():
            fast = jax.jit(fast)
            X, t = timed(fast, F, B)
            X, t = timed(fast, F, B)
            parts.append(check(op, *_tol_pair(X, jax.jit(ref)(F, B),
                                              dtype, n)))
            parts.append(f"t_{op}={t * 1e3:.1f}ms")
        (ld, info), t = timed(jax.jit(lambda a: ct.logdet("L", a)), A)
        ld_ref, _ = jax.jit(
            lambda a: lapack_ref.logdet("L", a, ORACLE_NB))(A)
        parts.append(check("logdet", abs(float(ld) - float(ld_ref)),
                           tol(dtype, n, abs(float(ld_ref)))))
        parts.append(check("logdet_info", abs(int(info)), 0))
        log(f"solve[{name}] n={n} nrhs={nrhs} {' '.join(parts)} "
            f"t_phase={time.perf_counter() - t0:.1f}s")


def phase_complex(n=N_COMPLEX):
    import jax
    import jax.numpy as jnp
    import cholesky_tpu as ct
    from cholesky_tpu.ops import lapack_ref

    for letter, dtype in (("c", jnp.complex64), ("z", jnp.complex128)):
        A = spd(n, dtype, seed=4)
        f = jax.jit(lambda a: getattr(ct, letter + "potrf")("L", a))
        (F, info), t = timed(f, A)
        (F, info), t = timed(f, A)
        Lo, _ = jax.jit(lambda a: lapack_ref.potrf("L", a, ORACLE_NB))(A)
        parts = [check("info", abs(int(info)), 0),
                 check("resid", backward_residual(A, F),
                       RESID_TOL["float32" if letter == "c" else "float64"]),
                 check("vs_oracle", *_tol_pair(jnp.tril(F), jnp.tril(Lo),
                                               dtype, n))]
        log(f"complex[{letter}potrf] n={n} dtype={jnp.dtype(dtype).name} "
            f"{' '.join(parts)} t_potrf={t * 1e3:.1f}ms")


def phase_gp(n=N_GP, d=D_GP):
    import jax
    import jax.numpy as jnp
    from cholesky_tpu.models.gp import GPParams, gp_train_step

    step = jax.jit(gp_train_step, static_argnames=("backend",))
    kx, ky = jax.random.split(jax.random.PRNGKey(5))
    X64 = jax.random.normal(kx, (n, d), jnp.float64)
    y64 = jnp.sin(X64[:, 0]) + 0.1 * jax.random.normal(ky, (n,), jnp.float64)
    p64 = GPParams.init(jnp.float64)

    def run(params, X, y, backend):
        (new, nll, info), t = timed(
            lambda *a: step(*a, backend=backend), params, X, y)
        grads = [(float(p) - float(q)) / 1e-2 for p, q in zip(params, new)]
        finite = all(bool(jnp.isfinite(q)) for q in new)
        return float(nll), grads, int(info), finite, t

    nll, g, info, fin, t_first = run(p64, X64, y64, "auto")
    nll, g, info, fin, t64 = run(p64, X64, y64, "auto")
    nll_r, g_r, info_r, fin_r, t_ref = run(p64, X64, y64, "ref")
    parts = [check("info", abs(info) + abs(info_r), 0),
             check("nonfinite_params", int(not (fin and fin_r)), 0),
             check("nll_vs_ref", abs(nll - nll_r) / abs(nll_r), GP_F64_RTOL)]
    for name, a, b in zip(("g_amp", "g_len", "g_noise"), g, g_r):
        parts.append(check(f"{name}_vs_ref", abs(a - b) / abs(b),
                           GP_F64_RTOL))
    log(f"gp[float64] n={n} d={d} nll={nll:.10e} {' '.join(parts)} "
        f"t_first={t_first:.2f}s t_step={t64 * 1e3:.1f}ms "
        f"t_step_ref={t_ref * 1e3:.1f}ms")

    X32, y32 = X64.astype(jnp.float32), y64.astype(jnp.float32)
    p32 = GPParams.init(jnp.float32)
    nll32, g32, info32, fin32, t_first32 = run(p32, X32, y32, "auto")
    nll32, g32, info32, fin32, t32 = run(p32, X32, y32, "auto")
    parts = [check("info", abs(info32), 0),
             check("nonfinite_params", int(not fin32), 0),
             check("nll_vs_f64", abs(nll32 - nll) / abs(nll),
                   GP_F32_NLL_RTOL)]
    # reported, not gated: K's condition (~1e5 at log_noise=-1) amplifies
    # f32 rounding in potri's K⁻¹ far past any tight gradient bound
    dev = " ".join(f"{k}_dev={abs(a - b) / abs(b):.2e}" for k, a, b
                   in zip(("g_amp", "g_len", "g_noise"), g32, g))
    log(f"gp[float32] n={n} d={d} nll={nll32:.6e} {' '.join(parts)} {dev} "
        f"t_first={t_first32:.2f}s t_step={t32 * 1e3:.1f}ms")

    import __graft_entry__
    fn, args = __graft_entry__.entry()
    out, t = timed(jax.jit(fn), *args)
    log(f"graft_entry nll={float(out):.6e} "
        f"{check('nonfinite', int(not bool(jnp.isfinite(out))), 0)} "
        f"t_first={t:.2f}s")


def phase_four_cards(n=N_DIST, n_gp=N_GP_DIST, nb_gp=NB_GP_DIST):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import cholesky_tpu as ct
    from cholesky_tpu.models.gp import GPParams, gp_nll
    from cholesky_tpu.models.gp_dist import make_gp_train_step
    from cholesky_tpu.parallel.potrf import potrf_sharded

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"chip_smoke --four-cards: {len(devs)} devices")
    mesh = Mesh(np.array(devs[:4]), ("d",))
    A = spd(n, jnp.float64, seed=6)
    sharded = jax.jit(lambda a: potrf_sharded("L", a, mesh))
    (Fd, info_d), t_first = timed(sharded, A)
    (Fd, info_d), t_dist = timed(sharded, A)
    Fs, info_s = jax.jit(lambda a: ct.potrf("L", a))(A)
    # both drivers restore A's strict upper triangle, so whole matrices
    # compare like their factors (and no tril copy of 8.6 GB is made)
    parts = [check("info", abs(int(info_d)) + abs(int(info_s)), 0),
             check("vs_single", *_tol_pair(Fd, Fs, jnp.float64, n))]
    del A, Fd, Fs
    log(f"four-cards[potrf_sharded] n={n} dtype=float64 {' '.join(parts)} "
        f"t_first={t_first:.2f}s t_potrf_sharded={t_dist * 1e3:.1f}ms")

    gmesh = Mesh(np.array(devs[:4]).reshape(1, 4), ("dp", "mp"))
    step = make_gp_train_step(gmesh, n_gp, D_GP, 1, nb=nb_gp,
                              dtype=jnp.float64)
    kx, ky, kz = jax.random.split(jax.random.PRNGKey(7), 3)
    X = jax.random.normal(kx, (1, n_gp, D_GP), jnp.float64)
    y = jnp.sin(X[..., 0]) + 0.1 * jax.random.normal(ky, (1, n_gp),
                                                     jnp.float64)
    probes = jnp.where(jax.random.bernoulli(kz, 0.5, (1, n_gp, 2)), 1.0, -1.0)
    X = jax.device_put(X, NamedSharding(gmesh, P("dp", None, None)))
    y = jax.device_put(y, NamedSharding(gmesh, P("dp", None)))
    probes = jax.device_put(probes, NamedSharding(gmesh, P("dp", None, None)))
    params = GPParams.init(jnp.float64)
    (new, nll_d, infos), t_gp = timed(step, params, X, y, probes)
    (new, nll_d, infos), t_gp = timed(step, params, X, y, probes)
    nll_s, info_1 = jax.jit(gp_nll)(params, X[0], y[0])
    parts = [check("info", int(np.abs(np.asarray(infos)).sum())
                   + abs(int(info_1)), 0),
             check("nll_vs_single",
                   abs(float(nll_d) - float(nll_s)) / abs(float(nll_s)),
                   GP_F64_RTOL)]
    # peak bytes over the whole phase: what each card held for the
    # sharded factorization and the distributed step
    held = " ".join(
        f"dev{i}={(d.memory_stats() or {}).get('peak_bytes_in_use', 'n/a')}"
        for i, d in enumerate(devs[:4]))
    log(f"four-cards[gp_dist] dp=1 mp=4 n_train={n_gp} nb={nb_gp} "
        f"{' '.join(parts)} t_step={t_gp * 1e3:.1f}ms "
        f"peak_bytes_in_use: {held}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed tier on four GPUs")
    args = ap.parse_args(argv)

    import jax
    dev = phase_device()
    from cholesky_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)

    if args.four_cards:
        phase_four_cards()
    else:
        phase_factor()
        phase_solve()
        phase_complex()
        phase_gp()
    if FAILURES:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILURES),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
