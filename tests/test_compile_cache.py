"""Persistent compile cache placement (utils/compile_cache.py)."""

from pathlib import Path

import jax

import cholesky_tpu
from cholesky_tpu.utils import compile_cache

ROOT = Path(cholesky_tpu.__file__).resolve().parents[1]


def test_env_var_is_the_only_directory(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    # JAX reads the variable itself; no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = compile_cache.enable_compile_cache()
        assert d == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
        assert compile_cache.enable_compile_cache() == d   # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_dir_is_gitignored():
    lines = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


def test_entry_scripts_use_the_helper():
    # every script that compiles for the card places its cache through the
    # one helper, and none names a directory of its own
    for rel in ("chip_smoke.py", "bench.py", "tools/sweep.py",
                "tools/layer_times.py", "__graft_entry__.py"):
        src = (ROOT / rel).read_text()
        assert "enable_compile_cache()" in src, rel
        assert "jax_compilation_cache_dir" not in src, rel
