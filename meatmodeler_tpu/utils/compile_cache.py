"""Where the persistent XLA compilation cache lives.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set this
module sets no directory. Otherwise the cache goes to the fixed
``<repo>/.cache/jax``. The directory is part of what makes a later process
find an earlier one's programs, so it never depends on the backend, a
temporary name, a pid or the time.

Call :func:`configure` before the process compiles anything: JAX decides
once, at its first compilation, whether a persistent cache is in use.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Optional

import jax

__all__ = ["REPO_CACHE_DIR", "configure", "directory_to_set"]

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".cache" / "jax"


def directory_to_set(environ: Mapping[str, str]) -> Optional[str]:
    """The directory the program must set itself, or None when the
    environment already names one."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(REPO_CACHE_DIR)


def configure(environ: Mapping[str, str] = os.environ) -> str:
    """Apply the cache rule above and return the directory in use."""
    directory = directory_to_set(environ)
    if directory is not None:
        jax.config.update("jax_compilation_cache_dir", directory)
    # Persist every program, however quick to compile or small: the eager
    # glue between the jitted stages dispatches dozens of small programs
    # whose compiles add up in a fresh process. XLA's own caches stay at
    # JAX's default (the GPU autotune results only): its kernel-reuse cache
    # file fails an internal check on the GPU when programs share it.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return jax.config.jax_compilation_cache_dir
