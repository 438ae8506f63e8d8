"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and JAX reads it
itself. Otherwise the cache lives at ``<checkout>/.jax_cache``: a fixed
path, because the path is part of the cache key and a directory that moves
never hits. Called once per process by the server, the benchmark, the
chip smoke test and the test suite.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure() -> str:
    """Point JAX at the cache directory; returns the directory in use."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_DIR
