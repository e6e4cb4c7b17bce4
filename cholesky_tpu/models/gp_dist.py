"""Distributed GP training step: dp (batch) × mp (matrix) sharding.

The multi-chip version of models/gp.py: a batch of independent GP problems
is data-parallel over the 'dp' mesh axis, and within each problem the
kernel matrix is block-cyclic over the 'mp' axis — the factorization,
log-determinant, and solves run as one shard_map SPMD program whose
collectives (psum diag broadcast, all_gather panel) ride the 'mp' axis,
while the gradient assembly and batch reduction are XLA-sharded over 'dp'.

Gradients use the standard large-scale GP estimator: exact quadratic terms
αᵀ(∂K)α plus Hutchinson trace probes tr(K⁻¹∂K) ≈ E_z[(K⁻¹z)ᵀ(∂K)z] with
Rademacher z — all linear algebra through the distributed factor, no
autodiff through the factorization.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cholesky_tpu import config
from cholesky_tpu.models.gp import GPParams, _kmatrix, _sqdist
from cholesky_tpu.parallel import blockcyclic
from cholesky_tpu.parallel.potrf import _potrf_dist_body, _logdet_body
from cholesky_tpu.parallel.trsm import _trsm_dist_body


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _to_blockcyclic_batched(K, nb: int, p: int):
    """(B, n, n) → (B, nblk, nb, npad) with cyclic block permutation and
    identity padding (traced; sharding applied by the caller)."""
    B, n, _ = K.shape
    npad = _round_up(max(n, nb), nb * p)
    if npad != n:
        K = jnp.pad(K, ((0, 0), (0, npad - n), (0, npad - n)))
        pad_diag = jnp.concatenate([jnp.zeros((n,), K.dtype),
                                    jnp.ones((npad - n,), K.dtype)])
        K = K + jnp.diag(pad_diag)[None]
    nblk = npad // nb
    blocks = K.reshape(B, nblk, nb, npad)
    return blocks[:, jnp.asarray(blockcyclic._perm(nblk, p))]


def make_gp_train_step(mesh: Mesh, n_train: int, n_features: int,
                       batch: int, nb: int = 8, n_probes: int = 2,
                       lr: float = 1e-2, dtype=jnp.float32):
    """Build a jitted distributed GP train step for the given mesh.

    mesh axes: ('dp', 'mp'). Returns step(params, X, y, probes) →
    (params', mean_nll, infos) where X is (batch, n_train, n_features)
    sharded over 'dp', y is (batch, n_train), probes is
    (batch, n_train, n_probes) Rademacher.
    """
    pdp = mesh.shape["dp"]
    pmp = mesh.shape["mp"]
    assert batch % pdp == 0
    npad = _round_up(max(n_train, nb), nb * pmp)
    nblk = npad // nb

    solve_body_n = functools.partial(_trsm_dist_body, nblk=nblk, nb=nb,
                                     npad=npad, axis="mp", trans="N")
    solve_body_t = functools.partial(_trsm_dist_body, nblk=nblk, nb=nb,
                                     npad=npad, axis="mp", trans="T")
    potrf_body = functools.partial(_potrf_dist_body, nblk=nblk, nb=nb,
                                   npad=npad, axis="mp", dtype=dtype)
    ld_body = functools.partial(_logdet_body, nb=nb, n=n_train, axis="mp")

    def factor_solve_one(Kbc, rhs):
        fact, info = potrf_body(Kbc)
        ld = ld_body(fact)
        x = solve_body_t(fact, solve_body_n(fact, rhs))
        return x, ld, info

    def factor_solve(Kbc, rhs):
        # vmap over the local dp batch; 'mp' collectives batch transparently
        return jax.vmap(factor_solve_one)(Kbc, rhs)

    factor_solve_sm = jax.shard_map(
        factor_solve, mesh=mesh,
        in_specs=(P("dp", "mp", None, None), P("dp", None, None)),
        out_specs=(P("dp", None, None), P("dp"), P("dp")))

    def step(params: GPParams, X, y, probes):
        B, n, _ = X.shape
        K = jax.vmap(lambda x: _kmatrix(params, x))(X)
        K = lax.with_sharding_constraint(
            K, NamedSharding(mesh, P("dp", None, None)))
        Kbc = _to_blockcyclic_batched(K, nb, pmp)
        Kbc = lax.with_sharding_constraint(
            Kbc, NamedSharding(mesh, P("dp", "mp", None, None)))

        rhs = jnp.concatenate([y[:, :, None], probes], axis=2)
        rhs = jnp.pad(rhs, ((0, 0), (0, npad - n), (0, 0)))
        sol, ld, info = factor_solve_sm(Kbc, rhs)
        sol = sol[:, :n]
        alpha = sol[:, :, 0]                                # (B, n) = K⁻¹y
        U = sol[:, :, 1:]                                   # (B, n, np) K⁻¹z

        quad = jnp.einsum("bn,bn->b", y, alpha,
                          precision=config.matmul_precision)
        nll = 0.5 * (quad + ld + n * jnp.log(2.0 * jnp.pi))

        # per-θ kernel derivative actions (data-parallel over dp)
        amp = jnp.exp(2.0 * params.log_amp)
        ell2 = jnp.exp(2.0 * params.log_len)
        noise = jnp.exp(2.0 * params.log_noise)
        D = jax.vmap(lambda x: _sqdist(x, x))(X)            # (B, n, n)
        Kf = amp * jnp.exp(-0.5 * D / ell2)
        dKs = {"amp": 2.0 * Kf, "len": Kf * (D / ell2)}

        def grad_of(dK):
            # ½[tr(K⁻¹dK) − αᵀdKα];  trace via Hutchinson probes
            dKz = jnp.einsum("bnm,bmp->bnp", dK, probes,
                             precision=config.matmul_precision)
            tr = jnp.mean(jnp.einsum("bnp,bnp->bp", U, dKz,
                                     precision=config.matmul_precision),
                          axis=1)
            dKa = jnp.einsum("bnm,bm->bn", dK, alpha,
                             precision=config.matmul_precision)
            qa = jnp.einsum("bn,bn->b", alpha, dKa,
                            precision=config.matmul_precision)
            return 0.5 * (tr - qa)

        g_amp = grad_of(dKs["amp"])
        g_len = grad_of(dKs["len"])
        # noise: dK = 2σₙ²·I → tr(K⁻¹dK) via probes, αᵀα exact
        tr_n = jnp.mean(jnp.einsum("bnp,bnp->bp", U, probes,
                                   precision=config.matmul_precision),
                        axis=1)
        aa = jnp.einsum("bn,bn->b", alpha, alpha,
                        precision=config.matmul_precision)
        g_noise = 0.5 * (tr_n - aa) * 2.0 * noise

        grads = GPParams(jnp.mean(g_amp), jnp.mean(g_len), jnp.mean(g_noise))
        new = GPParams(*(pp - lr * gg for pp, gg in zip(params, grads)))
        return new, jnp.mean(nll), info

    return jax.jit(step)
