"""Where the persistent XLA compilation cache lives.

The march loops take tens of seconds to compile, so every script keeps
compiled executables across processes. One rule for all of them: a
``JAX_COMPILATION_CACHE_DIR`` in the environment wins (JAX reads it
itself, and nothing here changes it); otherwise the cache is
``<checkout>/.jax_cache`` (listed in ``.gitignore``). The path is part
of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
