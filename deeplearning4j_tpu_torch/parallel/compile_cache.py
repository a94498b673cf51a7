"""The kernel build cache's directory.

Port of ``deeplearning4j_tpu/parallel/compile_cache.py``.  The reference
points JAX's persistent compilation cache at a directory; PyTorch runs
eagerly and has no such cache, and what the port compiles is its CUDA
kernels (``ops/cuda/build.py``), one shared library per source, built at
first use.  :func:`setup_compile_cache` points that build at a directory,
so processes (every rank of a multi-rank run, a later run) share one set
of libraries.

Opt-in by design: the directory comes from (highest wins)

1. an explicit ``cache_dir`` argument,
2. the ``DL4J_TPU_COMPILE_CACHE_DIR`` environment variable,

and when neither is set — or ``DL4J_TPU_COMPILE_CACHE=0`` — setup is a
no-op and the build keeps its own default (``DL4J_TORCH_BUILD_DIR`` or
``deeplearning4j_tpu_torch/_build/``).  Configuration is idempotent and
process-global: the first directory wins.
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_configured_dir: str | None = None

ENV_DIR = "DL4J_TPU_COMPILE_CACHE_DIR"
ENV_ENABLE = "DL4J_TPU_COMPILE_CACHE"


def setup_compile_cache(cache_dir: str | None = None, *,
                        min_compile_time_s: float = 0.0) -> str | None:
    """Point the kernel build at ``cache_dir``; returns the configured
    directory, or ``None`` when disabled or unset.  After the first
    configuration later calls return it unchanged (even with another
    directory: repointing mid-process would only split the cache).
    ``min_compile_time_s`` is the reference's knob and has no effect
    here: every kernel build is cached."""
    global _configured_dir
    if os.environ.get(ENV_ENABLE, "1") == "0":
        return None
    with _lock:
        if _configured_dir is not None:
            return _configured_dir
        target = cache_dir or os.environ.get(ENV_DIR)
        if not target:
            return None
        from ..ops.cuda import build

        os.makedirs(target, exist_ok=True)
        build.set_build_dir(target)
        _configured_dir = target
        return _configured_dir


def configured_dir() -> str | None:
    """The directory the kernel build points at (None if unset here)."""
    return _configured_dir


def _reset_for_tests() -> None:
    """Forget the process-global configuration (and the build's
    directory)."""
    global _configured_dir
    with _lock:
        if _configured_dir is not None:
            from ..ops.cuda import build

            build.set_build_dir(None)
        _configured_dir = None
