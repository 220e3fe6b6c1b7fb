"""Where JAX keeps its persistent compilation cache for this checkout's
scripts (chip_smoke.py, bench.py, benchmarks.py)."""
from __future__ import annotations

import os
from pathlib import Path


def use_checkout_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and it is
    left alone.  Otherwise the cache goes to `.jax_cache` at the root of
    this checkout — a fixed path, never one built from a temporary name,
    a process id or the time, so a second run of the same checkout finds
    what the first compiled.  Returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(__file__).resolve().parents[2] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
