"""The persistent XLA compilation cache, in one place.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it at start-up and
nothing here touches the configuration. Otherwise the cache lives at a fixed
path inside the checkout, ``<checkout>/.jax_cache``; a fixed path matters
because the directory is part of the cache's key, so a relative path that
moves with the working directory never hits.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
