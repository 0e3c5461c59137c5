"""Persistent XLA compilation cache for the scripts and the CLI.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, that is the
cache and nothing here changes it.  Otherwise the cache goes to one fixed
directory inside the checkout (``.jax_cache/``, listed in ``.gitignore``):
the path is part of what a later process looks up, so it must not move
between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR


def cache_entries(path: str) -> int:
    """Number of cached executables under ``path`` (0 if it does not exist)."""
    if not os.path.isdir(path):
        return 0
    return sum(len(files) for _, _, files in os.walk(path))
