"""Persistent XLA compile cache at a fixed place.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX already keeps its cache there and
nothing is set here.  Otherwise the cache goes to `<checkout>/.jax_cache`: a
fixed path, because the path is part of what a later process must find.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Returns the directory the compile cache lives in."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
