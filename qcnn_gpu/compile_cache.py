"""Where JAX keeps its persistent compile cache.

The cache directory is part of each entry's key, so it must not move
between runs: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads the
variable itself, and no other directory is set in code), otherwise a
fixed `.jax_cache/` at the checkout root (listed in .gitignore).
Called once by each entry point: the CLI, bench.py, chip_smoke.py and
scripts/bench_wide.py.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    """The directory the cache lives in (see module docstring)."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at `cache_dir()`; returns it."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
