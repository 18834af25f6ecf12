"""Persistent XLA compile cache.

The engine's kernels are compiled once per (bucket, lane) shape; the
on-disk cache lets every process after the first load them instead of
compiling again (the reference has no analogue — its external aligners
are AOT binaries; this is the JIT equivalent).

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and this
  module sets no directory;
- otherwise a fixed ``<checkout>/.jax_cache`` — fixed because the path
  is part of the cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

#: ``<checkout>/.jax_cache`` (listed in ``.gitignore``)
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def compile_cache_dir(environ=os.environ) -> str | None:
    """The directory this program must set, or None when
    ``JAX_COMPILATION_CACHE_DIR`` already tells JAX where the cache is."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT_CACHE_DIR


def enable_compile_cache() -> None:
    """Enable the persistent compilation cache (see the module docstring)."""
    import jax

    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
