"""Persistent XLA compilation cache.

The model's jitted step is one large program (two barotropic solves x
N_btp x kstages stages inside lax.scan) whose compile takes tens of seconds
at large grids. Caching compiled executables on disk lets every later
process on the same checkout start in seconds.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets no other directory; otherwise the cache lives at a fixed path inside
the checkout, `<checkout>/.jax_cache` (listed in .gitignore). The path is
part of the cache key, so it must not move between runs.

Call enable() after importing jax, before the first jit execution. Safe to
call multiple times and on any backend.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the default."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
