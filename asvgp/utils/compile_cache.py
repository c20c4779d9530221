"""One persistent XLA compilation cache for every script of the repository.

The cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that variable is set
(JAX then reads it by itself) and in ``<repo>/.jax_cache`` otherwise.  The
path is part of the cache key, so it is fixed rather than temporary.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache(min_compile_time_s: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return that directory."""
    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_s
    )
    return path
