"""Persistent compilation cache location.

Compiling the 20.97M-particle run programs takes tens of seconds; JAX's
persistent cache keeps them across processes. The cache path is part of
each entry's key, so it must not move between runs: it is either the
directory the environment names or a fixed directory in the checkout.
"""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "CHECKOUT_CACHE_DIR"]

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory before
    the first compile, and return that directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here; otherwise the cache goes to ``<checkout>/.jax_cache``
    (listed in ``.gitignore``).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
