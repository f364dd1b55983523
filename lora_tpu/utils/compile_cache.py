"""Persistent XLA compile cache, set up in one place.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
overrides it.  Otherwise the cache lives at one fixed path inside the
checkout (<repo>/.jax_cache, listed in .gitignore): the path is part of
the cache key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the compile cache uses: the environment's, else the
    fixed path inside the checkout."""
    return os.environ.get(ENV) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at cache_dir(); returns it."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
