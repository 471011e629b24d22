"""Persistent XLA compile cache, shared by every launcher of the repo.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this sets
no other directory. Otherwise the cache lives at `<checkout>/.jax_cache`:
a fixed path, because the path is part of the cache key, and inside the
checkout, because the program writes nothing outside it.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return os.environ.get(ENV_VAR) or CHECKOUT_CACHE


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory.
    Call before the first compilation."""
    import jax
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir()
