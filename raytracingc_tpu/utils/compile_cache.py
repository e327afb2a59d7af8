"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, ``bench.py``, ``chip_smoke.py``, the
tests): if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
nothing else is set; otherwise the cache lives in ``.jax_cache`` at the root
of the checkout, a fixed path, so that later processes find what earlier
ones compiled.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> tuple[str, bool]:
    """``(directory, from_env)``: the cache directory and whether
    ``JAX_COMPILATION_CACHE_DIR`` named it."""
    env_dir = environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir, True
    return os.path.join(CHECKOUT, ".jax_cache"), False


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`; return it."""
    import jax

    directory, from_env = compile_cache_dir()
    if not from_env:
        jax.config.update("jax_compilation_cache_dir", directory)
    return directory
