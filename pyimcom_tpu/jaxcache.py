"""
Persistent XLA compilation cache, one location for every entry point.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself.  When it is set, nothing
here overrides it; otherwise the cache lives at one fixed directory inside
the checkout (``.jax_cache``, listed in ``.gitignore``).  The path is part
of the cache key, so it is never derived from a temp name, a pid or the
time: a second process, or a rerun, finds what the first one compiled.
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir(environ=None) -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` if set, else the
    fixed in-checkout path."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV) or str(DEFAULT_DIR)


def enable(min_compile_secs: float = 0.5) -> str:
    """Point JAX's persistent cache at :func:`cache_dir` and return it.

    Sets ``jax_compilation_cache_dir`` only when the environment does not
    name a directory already."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
