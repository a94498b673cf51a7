"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``deeplearning4j_tpu_torch/csrc/<name>.cu`` compiles on its own into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/lib<name>-<hash>.so csrc/<name>.cu

The build runs at first use into ``deeplearning4j_tpu_torch/_build/``
(listed in ``.gitignore``; ``DL4J_TORCH_BUILD_DIR`` moves it, and so does
``parallel.setup_compile_cache``).  The file
name carries a hash of the source and the shared ``*.cuh`` headers, so an
edited source is rebuilt rather
than served stale.  :func:`build_all` starts one ``nvcc`` per source at
once and waits for all of them.  A failed build raises with the
compiler's output; there is no fallback.  A successful build keeps
``ptxas``'s report beside the library (``.log``); :func:`resource_usage`
reads each kernel's registers, spills and static shared memory from it.

Wrappers reach a C entry point through :func:`function`, which declares
its ``argtypes`` (every pointer and the stream as ``c_void_p``, every
int as ``c_int``).  Every C entry point returns ``cudaGetLastError()``
after its launch; :func:`check` turns a non-zero code into an exception
naming the error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


#: the directory ``parallel.setup_compile_cache`` chose (None: the default)
_dir_override: Path | None = None


def set_build_dir(path) -> None:
    """Build into ``path`` from now on (None: back to the default); a
    library already loaded stays loaded."""
    global _dir_override
    _dir_override = Path(path) if path is not None else None


def build_dir() -> Path:
    if _dir_override is not None:
        return _dir_override
    env = os.environ.get("DL4J_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[2] / "_build"


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            "kernels of deeplearning4j_tpu_torch cannot be built")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def _command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _compile(names: list[str]) -> None:
    """Run one ``nvcc`` per source, all started together; raise on any
    failure with that compiler's output."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
    if errors:
        raise RuntimeError("\n".join(errors))


def _load_locked(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = _target(name)
        if not path.exists():
            _compile([name])
        lib = ctypes.CDLL(str(path))
        lib.dl4j_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        return _load_locked(name)


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` with its
    ``argtypes`` declared and an ``int`` (CUDA error code) result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def build_all() -> float:
    """Build (in parallel) and load every kernel source; returns seconds."""
    t0 = time.perf_counter()
    with _lock:
        missing = [n for n in sources()
                   if n not in _libs and not _target(n).exists()]
        if missing:
            _compile(missing)
        for n in sources():
            _load_locked(n)
    return time.perf_counter() - t0


def resource_usage(name: str) -> list[dict]:
    """Per kernel of ``csrc/<name>.cu`` (mangled name): registers a
    thread, spill stores and loads and static shared memory (bytes), from
    the ``ptxas -v`` report of its build (empty if the build was not kept)."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        return []
    rows, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rows


def check(name: str, rc: int, what: str) -> None:
    """Raise if a C entry point of ``csrc/<name>.cu`` reported a CUDA
    error."""
    if rc != 0:
        msg = load(name).dl4j_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
