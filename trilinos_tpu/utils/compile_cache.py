"""Where JAX keeps its persistent compile cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here changes it. Otherwise the cache lives at a fixed ``.jax_cache/``
inside the checkout (listed in ``.gitignore``): the path is part of the
cache key, so a directory that moved between runs would never hit.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get(ENV) or str(CHECKOUT_CACHE)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on at ``cache_dir()``; returns
    the directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
