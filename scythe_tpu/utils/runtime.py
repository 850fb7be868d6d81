"""Small runtime utilities."""

from __future__ import annotations

import os

# <repo>/.jax_cache: a fixed path (the path is part of the cache key, so a
# directory that moves between runs never hits), listed in .gitignore.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is and nothing
    else is configured.  Otherwise the cache lives at ``<repo>/.jax_cache``
    and every compilation is cached, so a second run of the same program
    skips compiling."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        jax.config.update("jax_compilation_cache_dir", path)
        return path
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return REPO_CACHE_DIR
