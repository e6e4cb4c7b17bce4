"""Distributed triangular inverse, triangular square, and SPD inverse.

Completes the multi-GPU-tier parity of the reference (cuMultiGPUStrtri
strtri.c:474-534, cuMultiGPUSlauum slauum.c:308+, cuMultiGPUSpotri
spotri.c:48-69) on the block-cyclic layout:

- trtri_dist: ascending column-block sweep; column j is one distributed
  forward substitution L·W[:,j] = −L[:,j]·W_jj (reusing the potrf-tier
  solve loop — blocks ≤ j carry zeros through the substitution, so no
  masking is needed), with the diagonal block inverted redundantly on
  every device. In-place over the factor: ascending order touches only
  finalized columns.
- lauum_dist: W → WᴴW in one shot — every device syrk's its own masked row
  slabs (Σₗ WₗᴴWₗ) and a single psum over the axis assembles the full
  product, which owners then take their rows from. One collective total.
- potri_dist: trtri ∘ lauum, the reference's pure composition.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from cholesky_tpu import config
from cholesky_tpu.ops import lapack_ref
from cholesky_tpu.parallel.blockcyclic import BlockCyclic
from cholesky_tpu.parallel.trsm import _trsm_dist_body
from cholesky_tpu.types import Uplo, is_complex


def _conj(x):
    return x.conj() if is_complex(x.dtype) else x


def _trtri_dist_body(local, *, nblk, nb, npad, axis, dtype, tiles="auto"):
    from cholesky_tpu.parallel.potrf import _dist_tiles
    p = lax.axis_size(axis)
    me = lax.axis_index(axis)
    nlocal = local.shape[0]
    g = me + jnp.arange(nlocal, dtype=jnp.int32) * p
    gmask = g[:, None, None]
    solve_fwd = functools.partial(_trsm_dist_body, nblk=nblk, nb=nb,
                                  npad=npad, axis=axis, trans="N")
    t = _dist_tiles(dtype, tiles)     # same tiles as the single device

    def step(j, carry):
        local, info = carry
        owner = j % p
        lloc = j // p
        dl = lax.dynamic_slice(local, (lloc, 0, j * nb), (1, nb, nb))[0]
        Ljj = lax.psum(jnp.where(me == owner, dl, jnp.zeros_like(dl)), axis)
        if t is None:
            Wjj, linfo = lapack_ref.trti2(Uplo.LOWER, "N", Ljj)
        else:           # device-solver leaf / f64 Ozaki refinement
            Wjj, linfo = t.trti2(Ljj)
        Wjj = jnp.tril(Wjj)
        info = jnp.where((info == 0) & (linfo > 0),
                         linfo + j * nb, info).astype(jnp.int32)
        # rhs = −L[:, j]·W_jj for blocks > j (zeros elsewhere), replicated
        col = lax.dynamic_slice(local, (0, 0, j * nb), (nlocal, nb, nb))
        if t is None:
            prod = jnp.einsum("lrk,kc->lrc", col, Wjj,
                              precision=config.matmul_precision)
        else:
            prod = t.mm(col.reshape(nlocal * nb, nb),
                        Wjj).reshape(nlocal, nb, nb)
        contrib = jnp.where(gmask > j, -prod, jnp.zeros_like(col))
        gathered = lax.all_gather(contrib, axis)
        rhs = gathered.transpose(1, 0, 2, 3).reshape(npad, nb).astype(dtype)
        # forward substitution over the trailing blocks (zeros ride through
        # blocks ≤ j); columns > j of `local` still hold original L, as the
        # ascending sweep requires
        X = solve_fwd(local, rhs)             # (npad, nb) = W[:, j]
        # owners store their blocks of column j (and the owner stores W_jj)
        mine = jax.vmap(
            lambda gi: lax.dynamic_slice(X, (gi * nb, jnp.int32(0)),
                                         (nb, nb)))(g)
        sel = jnp.where(gmask > j, mine,
                        jnp.where(gmask == j, Wjj[None].astype(dtype), col))
        local = lax.dynamic_update_slice(local, sel.astype(dtype),
                                         (0, 0, j * nb))
        return local, info

    info0 = (lax.psum(local[0, 0, 0].real, axis) * 0).astype(jnp.int32)
    return lax.fori_loop(0, nblk, step, (local, info0))


def trtri_dist(bc: BlockCyclic, tiles: str = "auto"):
    """Distributed lower triangular inverse (non-unit). Returns
    (BlockCyclic inverse, info). tiles as in potrf_dist."""
    nblk, nb, npad = bc.local.shape
    body = functools.partial(_trtri_dist_body, nblk=nblk, nb=nb, npad=npad,
                             axis=bc.axis, dtype=bc.local.dtype, tiles=tiles)
    fn = jax.shard_map(body, mesh=bc.mesh,
                       in_specs=P(bc.axis, None, None),
                       out_specs=(P(bc.axis, None, None), P()))
    local, info = fn(bc.local)
    return BlockCyclic(local=local, n=bc.n, nb=bc.nb, mesh=bc.mesh,
                       axis=bc.axis), info


def _lauum_dist_body(local, *, nblk, nb, npad, axis):
    p = lax.axis_size(axis)
    me = lax.axis_index(axis)
    nlocal = local.shape[0]
    g = me + jnp.arange(nlocal, dtype=jnp.int32) * p
    # mask each slab to its lower-triangular content:
    # slab l, entry [r, c] is valid iff c ≤ g[l]·nb + r
    r = lax.broadcasted_iota(jnp.int32, (nlocal, nb, npad), 1)
    c = lax.broadcasted_iota(jnp.int32, (nlocal, nb, npad), 2)
    grow = g[:, None, None] * nb + r
    W = jnp.where(c <= grow, local, jnp.zeros_like(local))
    # Σₗ WₗᴴWₗ over owned row slabs, then one psum over the axis
    G = jnp.einsum("lrm,lrn->mn", _conj(W), W,
                   precision=config.matmul_precision)
    B = lax.psum(G, axis)                     # (npad, npad) replicated WᴴW
    # owners take their row blocks; keep the strict upper of the input
    rows_of = jax.vmap(lambda gi: lax.dynamic_slice(
        B, (gi * nb, jnp.int32(0)), (nb, npad)))(g)
    return jnp.where(c <= grow, rows_of.astype(local.dtype), local)


def lauum_dist(bc: BlockCyclic):
    """Distributed Lᴴ·L of a block-cyclic lower factor (lower triangle of
    the result; the strict upper region of the slabs passes through)."""
    nblk, nb, npad = bc.local.shape
    body = functools.partial(_lauum_dist_body, nblk=nblk, nb=nb, npad=npad,
                             axis=bc.axis)
    # pure-XLA body (einsum + psum): checker unconditionally ON
    fn = jax.shard_map(body, mesh=bc.mesh,
                       in_specs=P(bc.axis, None, None),
                       out_specs=P(bc.axis, None, None),
                       check_vma=True)
    local = fn(bc.local)
    return BlockCyclic(local=local, n=bc.n, nb=bc.nb, mesh=bc.mesh,
                       axis=bc.axis)


def potri_dist(bc: BlockCyclic):
    """Distributed SPD inverse from the distributed Cholesky factor:
    trtri_dist ∘ lauum_dist (reference cuMultiGPUSpotri, spotri.c:48-69)."""
    W, info = trtri_dist(bc)
    return lauum_dist(W), info


def potri_sharded(uplo, A, mesh, axis: str = "d", nb: int = 256):
    """Convenience: distribute a Cholesky factor, invert, collect."""
    from cholesky_tpu.parallel.blockcyclic import collect, distribute
    from cholesky_tpu.types import norm_uplo
    uplo = norm_uplo(uplo)
    W = A.conj().T if uplo == Uplo.UPPER else A
    bc = distribute(W, mesh, axis=axis, nb=nb)
    out, info = potri_dist(bc)
    R = collect(out)
    if uplo == Uplo.UPPER:
        return jnp.triu(R.conj().T) + jnp.tril(A, -1), info
    return jnp.tril(R) + jnp.triu(A, 1), info
