"""Distributed triangular solve against a block-cyclic lower factor.

Completes the multi-chip solver path (factor with parallel/potrf.py, then
solve): the analog of using the reference's cuMultiGPUStrsm after
cuMultiGPUSpotrf (reference blas/strsm.c multiGPU tier).

The right-hand side is replicated (tall-skinny, nrhs ≪ n); per block step
the diagonal solve is computed redundantly on every device (cheaper than a
broadcast round-trip — same reasoning as the distributed potrf) and the
substitution updates travel as collectives:
  forward  (L·x = b): column j of L is spread across row-block owners →
                      all_gather the per-device update rows;
  backward (Lᵀ·x = b): row block j lives on ONE owner → psum-broadcast its
                      full update vector.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from cholesky_tpu import config
from cholesky_tpu.parallel.blockcyclic import BlockCyclic
from cholesky_tpu.types import is_complex


def _solve_diag(Ljj, rj, trans: str):
    return lax.linalg.triangular_solve(
        Ljj, rj, left_side=True, lower=True,
        transpose_a=trans != "N", conjugate_a=trans == "C",
        unit_diagonal=False)


def _trsm_dist_body(local, B, *, nblk, nb, npad, axis, trans):
    p = lax.axis_size(axis)
    me = lax.axis_index(axis)
    nlocal = local.shape[0]
    g = me + jnp.arange(nlocal, dtype=jnp.int32) * p
    m = B.shape[1]
    rows = jnp.arange(npad, dtype=jnp.int32)[:, None]

    def get_diag(j):
        lloc = j // p
        dl = lax.dynamic_slice(local, (lloc, 0, j * nb), (1, nb, nb))[0]
        return lax.psum(jnp.where(me == j % p, dl, jnp.zeros_like(dl)), axis)

    def fwd_step(j, r):
        Ljj = jnp.tril(get_diag(j))
        rj = lax.dynamic_slice(r, (j * nb, 0), (nb, m))
        xj = _solve_diag(Ljj, rj, "N")
        r = lax.dynamic_update_slice(r, xj, (j * nb, 0))
        # my row blocks i>j: upd_l = L_l[:, j·nb:(j+1)·nb] @ xj
        cols = lax.dynamic_slice(local, (0, 0, j * nb), (nlocal, nb, nb))
        upd = jnp.einsum("lrk,km->lrm", cols, xj,
                         precision=config.matmul_precision)
        upd = jnp.where(g[:, None, None] > j, upd, jnp.zeros_like(upd))
        # scatter my rows into the full column and psum (NOT all_gather:
        # psum's output is typed invariant over the axis, which keeps the
        # replicated carry r honest under check_vma).  Traffic cost: a ring
        # all-reduce of the (npad, m) scatter buffer moves ~2·npad·m per
        # device vs ~npad·m for an all_gather of shards — accepted because
        # m = nrhs is small on this tall-skinny path and the vma-invariant
        # typing is worth the 2× on a few-hundred-KB message (a
        # reduce_scatter+gather of only the live (nblk-j)·nb rows would
        # reclaim it if nrhs ever grows).
        mine = jnp.zeros((npad, m), upd.dtype)
        for l in range(nlocal):               # static unroll, nlocal = nblk/p
            mine = lax.dynamic_update_slice(mine, upd[l],
                                            (g[l] * nb, jnp.int32(0)))
        return r - lax.psum(mine, axis)

    def bwd_step(i, r):
        j = nblk - 1 - i
        Ljj = jnp.tril(get_diag(j))
        rj = lax.dynamic_slice(r, (j * nb, 0), (nb, m))
        xj = _solve_diag(Ljj, rj, trans)
        r = lax.dynamic_update_slice(r, xj, (j * nb, 0))
        # owner's row block j updates all earlier rows: w = L_jᴴ·xj,
        # masked to columns < j·nb
        lloc = j // p
        Lrow = lax.dynamic_slice(local, (lloc, 0, 0), (1, nb, npad))[0]
        LrowH = Lrow.conj().T if trans == "C" else Lrow.T
        w = jnp.matmul(LrowH, xj, precision=config.matmul_precision)
        w = jnp.where(rows < j * nb, w, jnp.zeros_like(w))
        w = lax.psum(jnp.where(me == j % p, w, jnp.zeros_like(w)), axis)
        return r - w

    if trans == "N":
        return lax.fori_loop(0, nblk, fwd_step, B)
    return lax.fori_loop(0, nblk, bwd_step, B)


def trsm_factor_dist(fbc: BlockCyclic, B, trans: str = "N"):
    """Solve op(L)·X = B against the distributed factor; B is a replicated
    (n, nrhs) array; returns replicated X (n, nrhs).
    trans ∈ {'N','T','C'}.

    (The *general* distributed triangular solve — any side/uplo/trans/diag,
    sharded wide B, reference cuMultiGPUStrsm blas.h:338-362 — is
    parallel/blas.trsm_dist; this one is specialized to the
    factor-then-solve path where L is already block-cyclic.)"""
    nblk, nb, npad = fbc.local.shape
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    if B.shape[0] != npad:
        B = jnp.pad(B, ((0, npad - B.shape[0]), (0, 0)))
    body = functools.partial(_trsm_dist_body, nblk=nblk, nb=nb, npad=npad,
                             axis=fbc.axis, trans=trans)
    # pure-XLA body (solves + psums): every collective output is typed
    # invariant, so the replicated out_spec is machine-checked
    fn = jax.shard_map(body, mesh=fbc.mesh,
                       in_specs=(P(fbc.axis, None, None), P()),
                       out_specs=P(), check_vma=True)
    X = fn(fbc.local, B)[:fbc.n]
    return X[:, 0] if squeeze else X


#: Back-compat alias (pre-round-2 name, before the general trsm_dist
#: landed in parallel/blas.py).
trsm_dist = trsm_factor_dist
