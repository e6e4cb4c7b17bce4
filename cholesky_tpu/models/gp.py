"""Flagship application model: Gaussian-process regression on the library.

The reference is a thesis numerical library with no application layer; its
motivating workload is the GP-marginal-likelihood style pipeline its README
and logdet routine point at (reference lapack/slogdet.c — "log-determinant
of the Cholesky diagonal", the GP-likelihood term). This module is that
workload built on the library's own primitives:

    NLL(θ) = ½ yᵀK⁻¹y + ½ log|K| + n/2·log 2π,   K = k_θ(X,X) + σₙ²I

- factorization:        ops potrf (blocked driver)
- solves:               ops trsm twice through the factor
- log-determinant:      logdet_from_factor
- gradients:            the exact closed form
                        ∂NLL/∂θ = ½ tr((K⁻¹ − ααᵀ)·∂K/∂θ),  α = K⁻¹y
                        with K⁻¹ from ops potri — no autodiff through the
                        factorization needed.

This also serves as the library's end-to-end integration test: one training
step exercises potrf, trsm, potri, and logdet together.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cholesky_tpu import config
from cholesky_tpu.ops import api as ops


class GPParams(NamedTuple):
    log_amp: jax.Array      # log marginal variance
    log_len: jax.Array      # log length-scale
    log_noise: jax.Array    # log noise stddev

    @staticmethod
    def init(dtype=jnp.float32):
        return GPParams(jnp.zeros((), dtype), jnp.zeros((), dtype),
                        jnp.asarray(-1.0, dtype))


def _sqdist(X1, X2):
    d = X1[:, None, :] - X2[None, :, :]
    return jnp.sum(d * d, axis=-1)


def rbf_kernel(params: GPParams, X1, X2=None):
    X2 = X1 if X2 is None else X2
    amp = jnp.exp(2.0 * params.log_amp)
    ell2 = jnp.exp(2.0 * params.log_len)
    return amp * jnp.exp(-0.5 * _sqdist(X1, X2) / ell2)


def _kmatrix(params: GPParams, X, jitter=1e-6):
    n = X.shape[0]
    noise = jnp.exp(2.0 * params.log_noise)
    return rbf_kernel(params, X) + (noise + jitter) * jnp.eye(n, dtype=X.dtype)


def gp_nll(params: GPParams, X, y, backend: str = "auto"):
    """Negative log marginal likelihood via potrf/trsm/logdet."""
    n = X.shape[0]
    K = _kmatrix(params, X)
    F, info = ops.potrf("L", K, backend=backend)
    ld = ops.logdet_from_factor(F)
    z = ops.trsm("L", "L", "N", "N", 1.0, F, y[:, None], backend=backend)
    quad = jnp.sum(z * z)
    return 0.5 * (quad + ld + n * jnp.log(2.0 * jnp.pi)), info


def gp_nll_and_grads(params: GPParams, X, y, backend: str = "auto"):
    """NLL and exact gradients w.r.t. (log_amp, log_len, log_noise).

    Uses ∂NLL/∂θ = ½·Σᵢⱼ Wᵢⱼ·(∂K/∂θ)ᵢⱼ with W = K⁻¹ − ααᵀ; K⁻¹ comes from
    the library's potri, so the whole gradient is forward computation —
    no autodiff through the factorization.
    """
    n = X.shape[0]
    K = _kmatrix(params, X)
    F, info = ops.potrf("L", K, backend=backend)
    ld = ops.logdet_from_factor(F)
    z = ops.trsm("L", "L", "N", "N", 1.0, F, y[:, None], backend=backend)
    alpha = ops.trsm("L", "L", "T", "N", 1.0, F, z, backend=backend)[:, 0]
    nll = 0.5 * (jnp.sum(z * z) + ld + n * jnp.log(2.0 * jnp.pi))

    Kinv_tri, _ = ops.potri("L", F, backend=backend)
    Kinv = jnp.tril(Kinv_tri) + jnp.tril(Kinv_tri, -1).T
    W = Kinv - alpha[:, None] * alpha[None, :]

    amp = jnp.exp(2.0 * params.log_amp)
    ell2 = jnp.exp(2.0 * params.log_len)
    D = _sqdist(X, X)
    Kf = amp * jnp.exp(-0.5 * D / ell2)       # noise-free kernel
    dK_damp = 2.0 * Kf                        # ∂K/∂log_amp
    dK_dlen = Kf * (D / ell2)                 # ∂K/∂log_len
    noise = jnp.exp(2.0 * params.log_noise)

    g_amp = 0.5 * jnp.sum(W * dK_damp)
    g_len = 0.5 * jnp.sum(W * dK_dlen)
    g_noise = 0.5 * jnp.trace(W) * 2.0 * noise
    return nll, GPParams(g_amp, g_len, g_noise), info


def gp_train_step(params: GPParams, X, y, lr=1e-2, backend: str = "auto"):
    """One SGD step on the GP hyperparameters. Returns (params', nll, info)."""
    nll, g, info = gp_nll_and_grads(params, X, y, backend=backend)
    new = GPParams(*(p - lr * gi for p, gi in zip(params, g)))
    return new, nll, info


def gp_predict(params: GPParams, X, y, Xs, backend: str = "auto"):
    """Posterior mean/variance at test points Xs (standard GP regression)."""
    K = _kmatrix(params, X)
    F, info = ops.potrf("L", K, backend=backend)
    Ks = rbf_kernel(params, X, Xs)            # (n, m)
    alpha = ops.trsm("L", "L", "T", "N", 1.0, F,
                     ops.trsm("L", "L", "N", "N", 1.0, F, y[:, None],
                              backend=backend), backend=backend)[:, 0]
    mean = jnp.matmul(Ks.T, alpha, precision=config.matmul_precision)
    V = ops.trsm("L", "L", "N", "N", 1.0, F, Ks, backend=backend)
    var = rbf_kernel(params, Xs, Xs).diagonal() - jnp.sum(V * V, axis=0)
    return mean, var, info
