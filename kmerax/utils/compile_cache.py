"""Persistent XLA compilation cache.

The entry points (cli, bench, chip_smoke, the gpu tests) enable it, so a
run after the first skips recompiling its steps. The cache lives where
`JAX_COMPILATION_CACHE_DIR` says when that is set (JAX reads the variable
itself); otherwise in `.jax_cache/` at the root of the checkout, a fixed
path that git ignores — the path is part of the cache key, so a directory
that moves never hits.
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable() -> str:
    """Turn the cache on; returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
