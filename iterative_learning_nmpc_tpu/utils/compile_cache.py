"""Persistent XLA compilation cache, set up the same way by every entry point.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing is
changed here. Otherwise the cache lives at the fixed path `<checkout>/.jax_cache`
(git-ignored): the path is part of the cache key, so it must not move between
runs.
"""
from __future__ import annotations

import os
from typing import Optional

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache() -> Optional[str]:
    """Point JAX's persistent cache at <checkout>/.jax_cache unless the
    environment already names a directory. Returns the path it set, else
    None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    return path
