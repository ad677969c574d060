"""Where JAX keeps its persistent compilation cache.

The solver loops are large while-loop programs that take seconds to
compile, so entry points (``chip_smoke.py``, ``bench.py``, the examples)
keep compiled programs across processes.  The cache directory is part
of the cache key, so it is a fixed path, never a temporary name:

* ``$JAX_COMPILATION_CACHE_DIR`` when it is set, and no other;
* otherwise ``<checkout>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """The cache directory the entry points use (see module docstring)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
