"""Where JAX keeps its persistent compilation cache.

A cache hit needs the same directory every time (the path is part of what
JAX records), so the default is one fixed directory inside the checkout.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

#: default cache directory: ``.jax_cache`` at the root of the checkout
#: (listed in .gitignore)
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set here; otherwise the cache goes to
    :data:`DEFAULT_DIR`. Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
