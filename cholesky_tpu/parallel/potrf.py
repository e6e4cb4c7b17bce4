"""Distributed block-cyclic Cholesky over a mesh axis (shard_map SPMD).

Rebuild of the reference's multi-GPU tier
(reference cuMultiGPUSpotrf, lapack/spotrf.c:400-468): there, a host loop
tiled trailing updates into per-GPU task closures with an explicit
synchronize barrier before each CPU diagonal factor; here the whole
factorization is ONE compiled SPMD program per device:

  step j:   psum-broadcast the owner's diagonal block        (≈ the barrier
            + host diag factor, spotrf.c:428,450 — but every device factors
            the nb×nb block redundantly, cheaper than a broadcast round-trip)
            panel update via the diagonal-inverse trick      (hybridSpotrf's
            TRMM-by-inverse, spotrf.c:252-256)
            all_gather the panel column (NCCL over NVLink)   (≈ the PCIe
            HtoD panel streaming, sgemm.c:280-302)
            local masked trailing SYRK on owned row blocks

Communication per step: one psum(nb²) + one all_gather(n·nb), device to
device; there is no host staging and no task queue (SURVEY.md §2.5
mapping).

The tier runs on the SAME tiles as the single-device driver — diagonal
blocks through the device-solver leaves (or the Ozaki refinement leaves
under tiles='ozaki'), panel and trailing updates through the tile matmuls
(reference bar: the multiGPU tier reuses the GPU kernels,
spotrf.c:400-468) — and the trailing update shrinks in ``phases`` static
width steps (K-phase outer unroll: each phase re-specializes the fori_loop
on a narrower live window, cutting the full-width masking waste from ~2×
to ~1 + 1/(2K) while keeping every shape static under jit).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from cholesky_tpu import config
from cholesky_tpu.ops import lapack_ref
from cholesky_tpu.parallel.blockcyclic import BlockCyclic, collect, distribute
from cholesky_tpu.utils.errors import check
from cholesky_tpu.types import Uplo, norm_uplo, is_complex, real_dtype


def _conj(x):
    return x.conj() if is_complex(x.dtype) else x


def _dist_tiles(dtype, tiles: str):
    """Tile backend for the distributed tier — the same tiles as the
    single-device driver (reference bar: the multiGPU tier reuses the GPU
    kernels, spotrf.c:400-468). tiles='auto' → XLA tiles for every
    dtype; 'ozaki' → the f64 Ozaki tiles; 'ref' → None, the oracle
    lapack_ref leaves."""
    from cholesky_tpu.ops import blocked
    dtype = jnp.dtype(dtype)
    check(tiles in ("auto", "ref", "ozaki"), "potrf_dist", 0,
          f"unknown tiles {tiles!r}; expected 'auto', 'ref' or 'ozaki'")
    if tiles == "ref":
        return None
    if tiles == "ozaki":
        check(dtype == jnp.dtype(jnp.float64), "potrf_dist", 0,
              f"ozaki tiles support float64 only, got {dtype}")
        return blocked._OzakiTiles()
    return blocked._XlaTiles(dtype)


def _potrf_dist_body(local, *, nblk, nb, npad, axis, dtype, tiles="auto",
                     phases=4, lookahead=True):
    """shard_map body: local is (nlocal, nb, npad) on each device."""
    p = lax.axis_size(axis)
    me = lax.axis_index(axis)
    nlocal = local.shape[0]
    g = me + jnp.arange(nlocal, dtype=jnp.int32) * p      # global block ids
    gmask = g[:, None, None]
    t = _dist_tiles(dtype, tiles)

    def factor_diag(diag):
        """nb×nb leaf: L = chol(diag), T = L⁻¹, info (both tril)."""
        if t is None:
            Ljj, linfo = lapack_ref.potf2(Uplo.LOWER, diag)
            Ljj = jnp.tril(Ljj)
            Tjj, _ = lapack_ref.trti2(Uplo.LOWER, "N", Ljj)
        else:     # device-solver leaves / f64 Ozaki refinement
            Ljj, linfo = t.potf2(diag)
            Ljj = jnp.tril(Ljj)
            Tjj, _ = t.trti2(Ljj)
        return Ljj, jnp.tril(Tjj), linfo

    def psum_diag(local, j):
        """Broadcast block (j,j) from its owner (clamped slice past the
        last block — callers never use that value)."""
        dl = lax.dynamic_slice(local, (j // p, 0, j * nb), (1, nb, nb))[0]
        return lax.psum(jnp.where(me == j % p, dl, jnp.zeros_like(dl)), axis)

    def make_step(off: int, width: int):
        """One factorization step specialized on the static live window
        [off, off+width) of the trailing columns."""

        def step(j, carry):
            local, info, Ljj, Tjj, linfo = carry
            # the reference's multiGPU host loop STOPS at the first failed
            # pivot (spotrf.c:400-468 checks info and breaks); the traced
            # equivalent freezes all writes once info != 0 — without this,
            # ~100 steps of clamped-pivot inverses compound to f32 overflow
            frozen = info > 0
            carry_in = carry
            if not lookahead:
                # --- diagonal block: psum from owner, factor on arrival ---
                Ljj, Tjj, linfo = factor_diag(psum_diag(local, j))
            # failure in THIS step: the reference stops mid-step — the
            # failing diagonal block keeps its (clamped) partial factor,
            # but the panel solve and trailing update do not run (the
            # clamped factor's inverse is unbounded and would overflow)
            fail_now = linfo > 0
            info = jnp.where((info == 0) & fail_now,
                             linfo + j * nb, info).astype(jnp.int32)
            # --- panel: row blocks i>j get A[i,j]·L_jj⁻ᴴ (inverse trick,
            #     hybridSpotrf spotrf.c:252-256); block j gets L_jj ---
            col = lax.dynamic_slice(local, (0, 0, j * nb), (nlocal, nb, nb))
            col2 = col.reshape(nlocal * nb, nb)
            if t is None:
                newcol2 = jnp.matmul(col2, _conj(Tjj).T,
                                     precision=config.matmul_precision)
            else:
                newcol2 = t.mm(col2, Tjj, tb="C")
            newcol = newcol2.reshape(nlocal, nb, nb)
            below = jnp.where(fail_now, col, newcol)
            sel = jnp.where(gmask > j, below,
                            jnp.where(gmask == j, Ljj[None], col))
            local = lax.dynamic_update_slice(local, sel.astype(dtype),
                                             (0, 0, j * nb))
            # --- gather the panel column (zero for blocks ≤ j) ---
            contrib = jnp.where((gmask > j) & ~fail_now, newcol,
                                jnp.zeros_like(newcol))
            gathered = lax.all_gather(contrib, axis)    # (p, nlocal, nb, nb)
            panel = gathered.transpose(1, 0, 2, 3).reshape(npad, nb)
            panel_w = panel[off:off + width]            # static live window
            if lookahead:
                # --- lookahead (the collective-era version of the reference's
                # stream overlap, spotrf.c:311-313 / hybridSpotrf :207-259):
                # step j+1's diagonal = A[j+1,j+1]_pre − P·Pᴴ with P = the
                # OWNER's local panel block for row j+1, folded into one
                # psum — so the chain (nb×nb matmul + psum + factor) uses
                # only pre-gather local data: it is independent of both the
                # all_gather above and the big trailing GEMM below, the
                # scheduler can overlap all three, and the psum proves the
                # carry invariant over the mesh axis (check_vma-clean).
                # Step j+1 then starts its panel solve factor-in-hand.
                lloc_n = (j + 1) // p
                dl_n = lax.dynamic_slice(local, (lloc_n, 0, (j + 1) * nb),
                                         (1, nb, nb))[0]
                Pn = lax.dynamic_slice(contrib, (lloc_n, 0, 0),
                                       (1, nb, nb))[0]
                if t is None:
                    upd_n = jnp.matmul(Pn, _conj(Pn).T,
                                       precision=config.matmul_precision)
                else:
                    upd_n = t.mm(Pn, Pn, tb="C")
                dn = lax.psum(
                    jnp.where(me == (j + 1) % p,
                              dl_n - upd_n.astype(dtype),
                              jnp.zeros_like(dl_n)), axis)
                Lnx, Tnx, linx = factor_diag(dn)
            else:
                Lnx, Tnx, linx = Ljj, Tjj, linfo
            # --- trailing update on the live window of my row blocks:
            #     A[i, off:] -= L[i,j] · panel_wᴴ  (cols ≤ j·nb are zero) ---
            contrib2 = contrib.reshape(nlocal * nb, nb)
            if t is None:
                upd2 = jnp.matmul(contrib2, _conj(panel_w).T,
                                  precision=config.matmul_precision)
            else:
                upd2 = t.mm(contrib2, panel_w, tb="C")
            upd = upd2.reshape(nlocal, nb, width)
            W = local[:, :, off:off + width]
            Wnew = jnp.where(gmask > j, W - upd.astype(dtype), W)
            local = lax.dynamic_update_slice(local, Wnew, (0, 0, off))
            out = (local, info, Lnx, Tnx, linx)
            return jax.tree.map(lambda a, b: jnp.where(frozen, a, b),
                                carry_in, out)

        return step

    # initial info must carry the same varying-axes signature as the loop
    # output: psum over this axis of a local-derived zero gives exactly the
    # vma of the in-loop info (invariant over `axis`, varying over any
    # outer batch axes the caller sharded `local` on).
    info0 = (lax.psum(local[0, 0, 0].real, axis) * 0).astype(jnp.int32)
    info = info0
    # lookahead prologue: factor block (0,0) once, outside the loop
    L0, T0, li0 = factor_diag(psum_diag(local, 0))
    if not lookahead:      # keep the carry signature; values recomputed
        L0, T0, li0 = jnp.zeros_like(L0), jnp.zeros_like(T0), li0 * 0
    carry = (local, info, L0, T0, li0)
    # K-phase shrinking width: phase k runs steps [bounds[k], bounds[k+1])
    # over the static window [bounds[k]·nb, npad)
    K = max(1, min(phases, nblk))
    bounds = [round(nblk * k / K) for k in range(K + 1)]
    for k in range(K):
        j0, j1 = bounds[k], bounds[k + 1]
        if j0 == j1:
            continue
        off = j0 * nb
        carry = lax.fori_loop(j0, j1, make_step(off, npad - off), carry)
    return carry[0], carry[1]


def potrf_dist(bc: BlockCyclic, tiles: str = "auto", phases: int = 4,
               lookahead: bool = True):
    """Distributed lower Cholesky of a block-cyclic matrix.
    Returns (BlockCyclic factor, info). Lower triangle of the logical
    matrix holds L; the strict upper region is left as-is (garbage).

    tiles as in :func:`_dist_tiles`: 'auto' runs the same tiles as the
    single-device driver, 'ozaki' the f64 Ozaki tiles, 'ref' the oracle
    leaves.
    phases = number of static shrinking-width stages for the trailing
    update (1 reproduces the round-1 full-width behavior).
    lookahead=True factors step j+1's diagonal alongside step j's trailing
    GEMM (the reference's stream overlap, spotrf.c:311-313, rebuilt as
    loop-carried pipelining); False reproduces the round-2 serial steps."""
    nblk, nb, npad = bc.local.shape
    body = functools.partial(_potrf_dist_body, nblk=nblk, nb=nb, npad=npad,
                             axis=bc.axis, dtype=bc.local.dtype,
                             tiles=tiles, phases=phases, lookahead=lookahead)
    fn = jax.shard_map(body, mesh=bc.mesh,
                       in_specs=P(bc.axis, None, None),
                       out_specs=(P(bc.axis, None, None), P()))
    local, info = fn(bc.local)
    return BlockCyclic(local=local, n=bc.n, nb=bc.nb, mesh=bc.mesh,
                       axis=bc.axis), info


def potrf_sharded(uplo, A, mesh, axis: str = "d", nb: int = 256,
                  tiles: str = "auto", phases: int = 4,
                  lookahead: bool = True):
    """Convenience driver: distribute → factor → collect.

    Upper storage is canonicalized to lower by conjugate transposition, as
    in ops/blocked.py; the opposite strict triangle of A is restored.
    """
    uplo = norm_uplo(uplo)
    W = A.conj().T if uplo == Uplo.UPPER else A
    bc = distribute(W, mesh, axis=axis, nb=nb)
    fbc, info = potrf_dist(bc, tiles=tiles, phases=phases,
                           lookahead=lookahead)
    F = collect(fbc)
    if uplo == Uplo.UPPER:
        return jnp.triu(F.conj().T) + jnp.tril(A, -1), info
    return jnp.tril(F) + jnp.triu(A, 1), info


def _logdet_body(local, *, nb, n, axis):
    """Per-device log-det contribution of a distributed factor:
    2·Σ log(diag) over owned blocks, psum'd over the mesh axis."""
    p = lax.axis_size(axis)
    me = lax.axis_index(axis)
    rdt = real_dtype(local.dtype)
    nlocal = local.shape[0]
    g = me + jnp.arange(nlocal, dtype=jnp.int32) * p
    r = jnp.arange(nb, dtype=jnp.int32)
    cols = g[:, None] * nb + r[None, :]                   # (nlocal, nb)
    # d[l, r] = local[l, r, g[l]*nb + r] — the diagonal of block l
    d = jax.vmap(lambda blk, c: blk[r, c])(local, cols)
    valid = cols < n                                      # mask identity pad
    logs = jnp.where(valid, jnp.log(d.real.astype(rdt)), 0.0)
    return lax.psum(2.0 * jnp.sum(logs), axis)


def logdet_dist(bc: BlockCyclic, tiles: str = "auto", phases: int = 4):
    """Distributed SPD log-determinant: factor + local log-diag + psum.
    Returns (value, info). (The reference has no multi-GPU logdet —
    this closes that gap.)"""
    fbc, info = potrf_dist(bc, tiles=tiles, phases=phases)
    nblk, nb, npad = fbc.local.shape
    body = functools.partial(_logdet_body, nb=nb, n=fbc.n, axis=fbc.axis)
    val = jax.shard_map(body, mesh=fbc.mesh,
                        in_specs=P(fbc.axis, None, None),
                        out_specs=P())(fbc.local)
    return val, info


def logdet_sharded(uplo, A, mesh, axis: str = "d", nb: int = 256):
    uplo = norm_uplo(uplo)
    W = A.conj().T if uplo == Uplo.UPPER else A
    bc = distribute(W, mesh, axis=axis, nb=nb)
    return logdet_dist(bc)
