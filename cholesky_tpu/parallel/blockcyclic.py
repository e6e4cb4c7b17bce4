"""Block-cyclic distribution of a dense matrix over a device mesh axis.

Replacement for the reference's multi-GPU layer (reference
multigpu/multigpu.c task pool + blas/sgemm.c:432-566 output tiling): instead
of a host-resident matrix tiled into per-GPU task closures streamed over
PCIe, the matrix lives in device memory, sharded by *row block-cycles* over
a mesh axis, and the drivers are single compiled SPMD programs (shard_map)
whose communication is XLA collectives (NCCL over NVLink between GPUs) —
the schedule the reference's pthread queues approximated by hand is XLA's
static schedule here.

Layout: the n×n matrix is padded to nblk·nb rows (identity-padded by the
drivers), split into nblk row blocks of nb rows, and row block g lives on
device g mod P. The process-level array is (nblk, nb, n_padded), block-
cyclically *pre-permuted* so that plain axis-0 sharding gives device d the
blocks d, d+P, d+2P, … in local order — the ScaLAPACK 1-D cyclic layout.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class BlockCyclic:
    """A block-cyclically distributed square matrix.

    ``local``: (nblk, nb, np) array sharded on axis 0 over ``axis``;
    device d holds rows [d·nlocal:(d+1)·nlocal] = global blocks d, d+P, …
    ``n``: the logical (unpadded) dimension; ``np`` = nblk·nb ≥ n.
    """
    local: jax.Array
    n: int
    nb: int
    mesh: Mesh
    axis: str

    @property
    def npad(self) -> int:
        return self.local.shape[0] * self.nb

    @property
    def nblk(self) -> int:
        return self.local.shape[0]


def _perm(nblk: int, p: int) -> np.ndarray:
    """Global block order so that contiguous axis-0 shards are cyclic:
    position d·nlocal + l  ←  global block l·p + d."""
    nlocal = nblk // p
    return np.array([d + l * p for d in range(p) for l in range(nlocal)])


def distribute(A, mesh: Mesh, axis: str = "d", nb: int = 256,
               pad_identity: bool = True) -> BlockCyclic:
    """Shard a square matrix block-cyclically over ``mesh[axis]``.

    Pads n up so the block count divides the mesh axis; the pad region is
    an identity block (exact for the triangular drivers, see
    ops/blocked.py padding note).
    """
    n = A.shape[0]
    p = mesh.shape[axis]
    npad = _round_up(max(n, nb), nb * p)
    if npad != n:
        Ap = jnp.pad(A, ((0, npad - n), (0, npad - n)))
        if pad_identity:
            pad_diag = jnp.concatenate([
                jnp.zeros((n,), A.dtype), jnp.ones((npad - n,), A.dtype)])
            Ap = Ap + jnp.diag(pad_diag)
    else:
        Ap = A
    nblk = npad // nb
    blocks = Ap.reshape(nblk, nb, npad)
    blocks = blocks[jnp.asarray(_perm(nblk, p))]
    sharding = NamedSharding(mesh, P(axis, None, None))
    local = jax.lax.with_sharding_constraint(blocks, sharding) \
        if isinstance(blocks, jax.core.Tracer) else jax.device_put(blocks, sharding)
    return BlockCyclic(local=local, n=n, nb=nb, mesh=mesh, axis=axis)


def collect(bc: BlockCyclic) -> jax.Array:
    """Gather back to a replicated (n, n) matrix (inverse of distribute)."""
    nblk, nb, npad = bc.local.shape
    p = bc.mesh.shape[bc.axis]
    inv = np.argsort(_perm(nblk, p))
    full = bc.local[jnp.asarray(inv)].reshape(npad, npad)
    return full[:bc.n, :bc.n]
