"""Placement of JAX's persistent compilation cache for the repo's entry
points (tests, ``bench.py``, ``chip_smoke.py``)."""

from __future__ import annotations

import os

__all__ = ["use_compile_cache"]


def use_compile_cache(root: str, *, min_compile_secs: float = 0.5) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``$JAX_COMPILATION_CACHE_DIR`` wins when set: JAX reads it itself and
    no other directory is set. Otherwise the cache lives at the fixed path
    ``<root>/.jax_cache`` (the path is part of the cache key, so it must
    not move between runs). Programs that compile faster than
    ``min_compile_secs`` are not cached.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(os.path.abspath(root), ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
