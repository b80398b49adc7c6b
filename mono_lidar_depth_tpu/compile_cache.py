"""Persistent XLA compile cache placement for the entry points.

JAX keys cached executables by, among other things, the cache path, so
the directory must not move between runs.  `JAX_COMPILATION_CACHE_DIR`
wins when set (JAX reads it itself); otherwise the cache lives in
`<repo>/.jax_cache`, which `.gitignore` lists.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def use_compile_cache() -> str:
    """Point JAX's persistent compile cache at its fixed directory and
    return that directory.  Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
