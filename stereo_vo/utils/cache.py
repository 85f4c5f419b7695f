"""Persistent-compilation-cache setup shared by every entry point.

The directory is ``$JAX_COMPILATION_CACHE_DIR`` when set, else a fixed
``.jax_cache/`` at the root of the checkout (listed in ``.gitignore``). The
path is part of the cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compilation_cache_dir() -> str:
    """The cache directory this process uses (see module docstring)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup_compilation_cache() -> str:
    """Point jax's persistent compilation cache at ``compilation_cache_dir()``
    and return it. Raises ``OSError`` when the directory cannot be made."""
    import jax

    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
