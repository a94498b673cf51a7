"""Build the native host runtime: ``python -m deeplearning4j_tpu_torch.native.build``.

g++ -O3 shared library; no external deps.  It builds from
``src/host_runtime.cpp`` into the port's build directory
(``deeplearning4j_tpu_torch/_build/``, listed in ``.gitignore``;
``DL4J_TORCH_BUILD_DIR`` moves it, as it moves the CUDA kernels'), never
beside the source.  Several processes may ask for the library at once
(test workers, a server and its replicas): the compiler writes a
temporary file that ``os.replace`` moves into place, under an
``fcntl.flock`` on a lock file in the build directory, so no process
loads a half-written library and only one compiles it.  The library is
optional — every call site falls back to pure Python when it is absent.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).parent
SRC = HERE / "src" / "host_runtime.cpp"
LIB_NAME = "libdl4jtpu_host.so"


def build_dir() -> Path:
    env = os.environ.get("DL4J_TORCH_BUILD_DIR")
    return Path(env) if env else HERE.parent / "_build"


def lib_path() -> Path:
    return build_dir() / LIB_NAME


def stale(lib: Path) -> bool:
    """The reference's rule: missing, or older than its source."""
    return (not lib.exists() or (SRC.exists()
                                 and SRC.stat().st_mtime > lib.stat().st_mtime))


def _compile(lib: Path, verbose: bool) -> Path | None:
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        if verbose:
            print(f"native build unavailable: {e}", file=sys.stderr)
        return None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        if verbose:
            print(f"native build failed:\n{proc.stderr}", file=sys.stderr)
        return None
    os.replace(tmp, lib)
    if verbose:
        print(f"built {lib}")
    return lib


def build(verbose: bool = True, force: bool = True) -> Path | None:
    """Compile the library into :func:`build_dir` and return its path
    (None when ``g++`` is missing or fails).  ``force=False`` compiles
    only when no up-to-date library is there once the lock is held —
    another process may have built it meanwhile."""
    lib = lib_path()
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        lock = open(lib.parent / f"{LIB_NAME}.lock", "w")
    except OSError as e:
        if verbose:
            print(f"native build directory unavailable: {e}", file=sys.stderr)
        return None
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and not stale(lib):
            return lib
        return _compile(lib, verbose)


if __name__ == "__main__":
    sys.exit(0 if build() else 1)
