"""Where JAX keeps its persistent compilation cache.

Entry points (the CLI, ``bench.py``, ``chip_smoke.py``) call
:func:`enable_compile_cache` once, before their first compile — never
at import time, so importing the package stays free of side effects.
"""

from __future__ import annotations

import os

#: fixed default: the cache directory is part of the cache key, so a
#: path that moved between runs (temp dir, pid) would never hit
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is configured here; otherwise the cache goes to the fixed
    ``<repo>/.jax_cache`` (listed in ``.gitignore``)."""
    if os.environ.get(_ENV):
        return os.environ[_ENV]
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
