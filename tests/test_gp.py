"""Flagship GP model: NLL, exact gradients, prediction, train step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cholesky_tpu.models.gp import (
    GPParams, gp_nll, gp_nll_and_grads, gp_predict, gp_train_step,
)


def data(n=96, d=3, dtype=jnp.float32, seed=0):
    kx, ky = jax.random.split(jax.random.PRNGKey(seed))
    X = jax.random.normal(kx, (n, d), dtype)
    y = jnp.sin(2.0 * X[:, 0]) + 0.1 * jax.random.normal(ky, (n,), dtype)
    return X, y


def ref_nll_np(params, X, y, jitter=1e-6):
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    amp = np.exp(2 * float(params.log_amp))
    ell2 = np.exp(2 * float(params.log_len))
    noise = np.exp(2 * float(params.log_noise))
    d = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    K = amp * np.exp(-0.5 * d / ell2) + (noise + jitter) * np.eye(len(X))
    L = np.linalg.cholesky(K)
    z = np.linalg.solve(L, y)
    return 0.5 * (z @ z + 2 * np.sum(np.log(np.diag(L)))
                  + len(X) * np.log(2 * np.pi))


def test_gp_nll_matches_numpy():
    X, y = data()
    p = GPParams.init()
    nll, info = gp_nll(p, X, y)
    assert int(info) == 0
    ref = ref_nll_np(p, X, y)
    assert abs(float(nll) - ref) / abs(ref) < 1e-4


def test_gp_grads_match_finite_differences():
    X, y = data(n=64)
    X64, y64 = X.astype(jnp.float64), y.astype(jnp.float64)
    p = GPParams(jnp.asarray(0.1, jnp.float64), jnp.asarray(-0.2, jnp.float64),
                 jnp.asarray(-1.0, jnp.float64))
    nll, g, info = gp_nll_and_grads(p, X64, y64, backend="xla")
    assert int(info) == 0
    eps = 1e-6
    for i, name in enumerate(["log_amp", "log_len", "log_noise"]):
        pp = list(p)
        pp[i] = pp[i] + eps
        up, _ = gp_nll(GPParams(*pp), X64, y64, backend="xla")
        pp[i] = pp[i] - 2 * eps
        dn, _ = gp_nll(GPParams(*pp), X64, y64, backend="xla")
        fd = (float(up) - float(dn)) / (2 * eps)
        assert abs(fd - float(g[i])) < 1e-3 * max(1.0, abs(fd)), \
            f"{name}: fd={fd} exact={float(g[i])}"


def test_gp_train_step_decreases_nll():
    X, y = data(n=128)
    p = GPParams.init()
    nlls = []
    for _ in range(5):
        p, nll, info = gp_train_step(p, X, y, lr=5e-3)
        assert int(info) == 0
        nlls.append(float(nll))
    assert nlls[-1] < nlls[0]


def test_gp_predict_interpolates():
    X, y = data(n=128, seed=2)
    p = GPParams(jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(-2.0))
    mean, var, info = gp_predict(p, X, y, X[:10])
    assert int(info) == 0
    # at training points with small noise the posterior mean ≈ y
    assert float(jnp.max(jnp.abs(mean - y[:10]))) < 0.2
    assert np.all(np.asarray(var) > -1e-5)


def test_graft_entry():
    import importlib
    ge = importlib.import_module("__graft_entry__")
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(float(out))


def test_graft_dryrun_multichip():
    import importlib
    ge = importlib.import_module("__graft_entry__")
    ge.dryrun_multichip(len(jax.devices()))


@pytest.mark.slow
def test_graft_dryrun_child_self_provisions():
    """Bare `--dryrun-child N` must provision its own CPU device count.

    Guards the jax_num_cpu_devices fallback in __graft_entry__: the child
    is spawned WITHOUT the parent's --xla_force_host_platform_device_count
    flag and must still build a 4-device mesh (reference multiGPU tests
    degrade to whatever devices exist — cumultigpuspotrf.c:50-57)."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(root, "__graft_entry__.py"),
         "--dryrun-child", "4"],
        env=env, cwd=root, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dryrun_multichip ok" in r.stdout, r.stdout
