"""Persistent XLA compile cache.

First-time XLA compiles of the search/emission programs take tens of
seconds; a short-lived process — the CLI especially — would pay that on
every invocation.  JAX's persistent compilation cache makes every
geometry compile once per cache directory.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory.  Otherwise the cache lives at the fixed
in-checkout path ``<repo>/.jax_cache/`` (listed in ``.gitignore``): the
directory is part of the cache's key, so a path that moves never hits.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compile cache (idempotent) and return
    its directory.  Programs that compile faster than
    ``min_compile_secs`` are not cached."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return compile_cache_dir()
