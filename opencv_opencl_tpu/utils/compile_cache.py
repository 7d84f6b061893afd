"""Where JAX keeps its persistent compilation cache.

A compiled program is found again only under the directory it was stored
in, so the directory must not move between runs.  If the
``JAX_COMPILATION_CACHE_DIR`` environment variable is set, JAX reads it
itself and this module sets nothing.  Otherwise the cache lives at the
fixed ``<repo>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["REPO_CACHE_DIR", "compile_cache_dir", "enable_compile_cache"]

_ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def compile_cache_dir() -> str:
    """The cache directory in use: the variable's value if set, else
    ``<repo>/.jax_cache``."""
    return os.environ.get(_ENV) or REPO_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    path = compile_cache_dir()
    if not os.environ.get(_ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
