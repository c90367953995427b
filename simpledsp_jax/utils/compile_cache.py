"""Persistent XLA compilation cache for the entry points.

The entry points (``chip_smoke.py``, the ``bench*.py`` scripts and the
command line) call :func:`enable_compile_cache` once before their first
compile, so a second run of the same shapes loads executables instead of
compiling them again.  Library code never calls it.
"""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["REPO_CACHE_DIR", "enable_compile_cache"]

# A fixed path: the cache directory is part of what lets a later run find
# an entry, so it must not depend on a temp dir, a pid or a time.
REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here.  Otherwise the cache goes to
    ``<repo>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
