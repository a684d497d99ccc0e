"""The persistent compilation cache rule shared by every entry point
(``chip_smoke.py``, ``bench.py``, ``benchmarks/*.py``).

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing is
set here.  Otherwise the cache lives at the fixed ``<repo>/.jax_cache``
(listed in ``.gitignore``): the cache key includes the directory, so a path
built from the home directory, a temporary name, a pid or the time would
never hit again.
"""
from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache(root=REPO_ROOT):
    """Apply the cache rule; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
