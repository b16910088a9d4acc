"""JAX's persistent compile cache, shared by every entry point.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
is set here. Otherwise the cache lives in `.jax_cache` at the root of the
checkout, resolved from this package's own path: the directory is part of
every cache key, so it must not move with the working directory.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    DEFAULT_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
