"""f64 matmul via the Ozaki splitting scheme (exact int8 products).

Selected by ``backend='ozaki'``; f64 ``'auto'`` uses native FP64. This
module is the moral successor of the reference's
sm_13-era trick of storing doubles as hi/lo int pairs in 32-bit shared
memory (reference dgemm.cu:3-10, ztrmm.cu:4-36, SURVEY.md §2.2): represent
each f64 operand exactly as a short sum of int8 *slices* and recover the
product from integer matmuls.

Scheme (Ozaki et al.; the int8 tensor-core formulation):
  - scale row i of A (column j of B) by a power of two so entries land in
    [-1/2, 1/2]; peel S slices of 7 bits by round-and-subtract:
        a = 2^{eᵢ} · Σ_s qₛ·2^{-7(s+1)} + 2^{eᵢ-7S}·r_S,  qₛ ∈ [-64, 64]
    (the peel arithmetic is exact: ×128 is a power-of-two scale and the
    integer subtraction is representable, so the slices capture the
    leading 7S mantissa bits exactly)
  - every slice-pair product qₛᵀ·q′ₜ is an int8×int8 matmul accumulated in
    int32 — EXACT (no rounding; overflow-safe for K·64² ≲ 2³¹)
  - pairs with equal s+t share a weight and are summed in int32 (still
    exact), then the ≤S group sums recombine in f64 with the row/column
    scales; dropped pairs (s+t ≥ S) contribute < 2^{-7S} relative to the
    scale product.

With S=4 (10 int8 matmuls, 4 f64 axpys): elementwise error ≲
K·2^{-28}·rowscale·colscale — far inside the ≤1e-6 backward-error target
for the d-precision drivers, with every product on the int8 GEMM path.
S is tunable (S=6 → 21 matmuls, ~2^{-42} for near-f64 work).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

SLICE_BITS = 7
_RADIX = float(1 << SLICE_BITS)              # 128.0
# int32 overflow guard: K · 65² · S ≤ 2³¹ for group-summed pairs (|q| can
# reach 65: values just above 64 before the f32 round). Beyond this the K
# axis is split into exact chunks and the chunk products are summed in f64.
K_EXACT_MAX = 2 ** 31 // (65 * 65 * 8)       # = 63550


def _split_rows(A, slices: int):
    """Peel rows of an f64 matrix into int8 slices.
    Returns (slices (S, m, k) int8, row scale (m,) f64 power of two).

    All peel arithmetic runs in f32 on an (hi, lo) pair, where two-sum
    arithmetic keeps the round-and-subtract invariant exact:
      - exponents via f32 frexp (f64 frexp needs an unimplemented 64-bit
        bitcast); f32-rounding can only grow the exponent, keeping |r|≤~1/2
      - scales via f32 ldexp (jnp.exp2 lowers as exp(x·ln2) and ROUNDS)
      - the input enters as an exact f32 pair  x = hi + lo  (48 mantissa
        bits — beyond both the S≤6 slice range and the 1e-6 target)
    Row scales are limited to the f32 exponent range (~1e±38), fine for
    the drivers' SPD inputs.
    """
    amax = jnp.max(jnp.abs(A), axis=1, keepdims=True)
    amax = jnp.where(amax == 0, jnp.ones_like(amax), amax)
    _, ex = jnp.frexp(amax.astype(jnp.float32))
    inv = jnp.ldexp(jnp.ones_like(ex, jnp.float32), -(ex + 1))  # 1/(2·scale)
    scale = jnp.ldexp(jnp.ones_like(ex, jnp.float32), ex).astype(A.dtype)

    xh = A.astype(jnp.float32)               # correctly-rounded high part
    xl = (A - xh.astype(A.dtype)).astype(jnp.float32)  # exact residual
    rh = xh * inv                            # power-of-two scaling: exact
    rl = xl * inv
    outs = []
    for _ in range(slices):
        q = jnp.round(rh * _RADIX)           # native f32 round, |q| ≤ 64+1
        outs.append(q.astype(jnp.int8))
        s = rh * _RADIX - q                  # |diff| ≤ ½ ⇒ exact (Sterbenz)
        rlb = rl * _RADIX
        t = s + rlb                          # two-sum: new hi
        e = rlb - (t - s)                    # … and its exact error term
        rh, rl = t, e
    return jnp.stack(outs), 2.0 * scale[:, 0]


def _matmul_int8(a, b):
    """(m,k) int8 · (k,n) int8 → int32, exact (an integer GEMM)."""
    return lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)


def split_rows(A, slices: int):
    """Public pre-split entry: peel ``A`` (f64) into int8 row slices once,
    so callers with block structure (live-block TRMM, blocked drivers) can
    hoist the memory-bound peel out of their per-block matmuls and feed
    sub-blocks of the SAME representation to :func:`matmul_presplit` —
    restriction of a peeled representation to any sub-block stays an exact
    peel (the scale is per full row, only loosening the dropped-pair bound
    by rowmax/blockmax)."""
    return _split_rows(A, slices)


def matmul_presplit(As, ascale, Bs, bscale, out_dtype=jnp.float64):
    """C ≈ A·B from pre-peeled operands: ``As (S,m,k)`` int8 + row scales
    ``(m,)`` from ``split_rows(A)``; ``Bs (S,n,k)`` int8 + column scales
    ``(n,)`` from ``split_rows(B.T)``.  Same arithmetic and error bound as
    :func:`matmul_f64`; the peel cost is the caller's, paid once."""
    S, m, k = As.shape
    S2, n, k2 = Bs.shape
    assert S == S2 and k == k2, (As.shape, Bs.shape)
    if k > K_EXACT_MAX:
        # chunk the contraction axis: each chunk keeps the int32
        # no-overflow invariant; f64 partial sums are linear in the final
        # row/column scaling, so scaling inside each chunk is exact
        nchunks = -(-k // K_EXACT_MAX)
        step = -(-k // nchunks)
        acc = jnp.zeros((m, n), out_dtype)
        for c in range(0, k, step):
            w = min(step, k - c)
            acc = acc + matmul_presplit(As[:, :, c:c + w], ascale,
                                        Bs[:, :, c:c + w], bscale,
                                        out_dtype=out_dtype)
        return acc
    acc = jnp.zeros((m, n), out_dtype)
    for g in range(S):                       # weight group: s + t == g
        G = None
        for s in range(g + 1):
            P = _matmul_int8(As[s], Bs[g - s].T)         # exact int32
            G = P if G is None else G + P                # exact int32 sum
        # split into 12-bit halves so each converts exactly even where
        # int32 → f64 is lowered through f32 (exact only to 2^24)
        Ghi = G // 4096
        Glo = G - Ghi * 4096
        Gf = Ghi.astype(out_dtype) * 4096.0 + Glo.astype(out_dtype)
        acc = acc + Gf * (2.0 ** (-SLICE_BITS * (g + 2)))
    return acc * ascale[:, None] * bscale[None, :]


@functools.partial(jax.jit, static_argnames=("slices",))
def matmul_f64(A, B, *, slices: int = 4):
    """C ≈ A·B for f64 operands via exact int8-slice matmuls.
    Elementwise error ≲ K·2^{−7·slices}·rowscale(A)ᵢ·colscale(B)ⱼ.

    For K beyond the int32-exact bound the contraction axis is split into
    exact chunks whose partial products are summed in f64 — each chunk
    keeps the no-overflow invariant (and gets its own row/column scales,
    which only tightens the error bound)."""
    assert A.dtype == jnp.float64 and B.dtype == jnp.float64, \
        (A.dtype, B.dtype)
    m, k = A.shape
    k2, n = B.shape
    assert k == k2
    if k > K_EXACT_MAX:
        nchunks = -(-k // K_EXACT_MAX)
        step = -(-k // nchunks)
        acc = jnp.zeros((m, n), A.dtype)
        for c in range(0, k, step):
            w = min(step, k - c)
            acc = acc + matmul_f64(A[:, c:c + w], B[c:c + w, :],
                                   slices=slices)
        return acc

    As, ascale = _split_rows(A, slices)                  # (S, m, k), (m,)
    Bs, bscale = _split_rows(B.T, slices)                # (S, n, k), (n,)
    return matmul_presplit(As, ascale, Bs, bscale, out_dtype=A.dtype)
