"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory.  Otherwise the cache lives at a fixed path
inside the checkout (``.jax_cache/``, listed in ``.gitignore``): the path is
part of the cache key, so a directory that moved between runs would never
hit.  Keyed by HLO hash, so config/shape changes recompile as usual.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
