"""Where compiled XLA programs persist between processes.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set nothing
else is configured.  Otherwise the cache lives at a fixed path in the
checkout, ``<checkout>/.jax_cache``, so every process of every run finds
what an earlier one compiled (a cache directory that moves never hits).
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure_compile_cache() -> str:
    """Enable the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
