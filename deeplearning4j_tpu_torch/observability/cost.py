"""Analytic utilization accounting, counted on fake tensors.

Port of ``deeplearning4j_tpu/observability/cost.py``.  The reference asks
XLA's ``cost_analysis()`` of a compiled function; PyTorch runs eagerly and
has no such analysis, and the port's kernels are ``ctypes`` calls that
``torch.utils.flop_counter`` cannot see.  So :meth:`CostModel.capture`
runs the function once on fake tensors (``FakeTensorMode``: shapes and
dtypes, no storage, no device work) under a dispatch mode that counts:

- flops: the flop counter's formulas for every ATen op that has one
  (matrix products, convolutions, attention), 0 for the rest;
- bytes: each op's tensor operands and results (a view moves nothing; a
  gather reads what it writes; an in-place write counts its source);
- the kernels: each wrapper in ``ops/cuda`` has a fake branch that
  returns an empty output of the right shape and credits its own flops
  and bytes (:func:`kernel_work`), the formulas ``chip_smoke.py`` uses
  for its bound column.  It counts no launch.

Nothing runs on the device and no state changes: every tensor argument is
replaced by a fake, tensors the function reaches otherwise are converted
as they are met, and in-place writes land on the fakes.  ``source`` is
``"counted"``, or ``"analytic"`` for the caller's fallback.  The result
is cached per (key, argument signature), as the reference's.  Combined
with a measured wall time it publishes

    ``{prefix}.mfu`` = flops / (seconds * peak_flops)
    ``{prefix}.mbu`` = bytes_accessed / (seconds * peak_bytes_per_s)

against the card's own peaks (:data:`PEAK_FLOPS`): the same accounting as
``chip_smoke.py``'s MFU.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from . import core
from .metrics import METRICS

# Peaks keyed by a substring of the device name, lower case: one H100's
# (NVIDIA's data sheet, SXM, dense bf16; HBM3); the CPU rows are nominal,
# so CPU test runs publish finite, small shares rather than NaN.
PEAK_FLOPS: dict[str, float] = {
    "h100": 989e12,
    "cpu": 5e10,
}
PEAK_BYTES_PER_S: dict[str, float] = {
    "h100": 3.35e12,
    "cpu": 2e10,
}

_aten = torch.ops.aten
# ops that move no data of their own (allocation, metadata)
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided, _aten.detach,
               _aten.lift_fresh, _aten._unsafe_view}
# ops that read as many bytes of their table as they write
_GATHERS = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding,
            _aten.take}


def _lookup(table: dict[str, float], kind: str) -> float | None:
    kind = kind.lower()
    for key in sorted(table, key=len, reverse=True):
        if key in kind:
            return table[key]
    return None


def _device_kind() -> str:
    try:
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except RuntimeError:
        pass
    return "cpu"


@dataclass(frozen=True)
class CostInfo:
    """Per-execution cost of one function (the whole call)."""
    flops: float
    bytes_accessed: float
    source: str  # "counted" | "analytic"


def _nbytes(tree) -> int:
    """Bytes of the tensors in a (nested) op argument list."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(_nbytes(x) for x in tree.values())
    return 0


class _WorkCounter(TorchDispatchMode):
    """Counts the flops and bytes of the ATen ops dispatched under it, and
    the kernel work credited through :func:`kernel_work`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        written = _nbytes(out)
        if func.is_view or packet in _NO_TRAFFIC or not written:
            # a view, an allocation, or metadata (a size, a device)
            return out
        schema = func._schema.arguments
        if packet in _GATHERS:
            # the rows gathered, and the indices
            read = written + _nbytes(args[1:])
        elif schema and schema[0].alias_info is not None \
                and schema[0].alias_info.is_write:
            # an in-place or indexed write: its sources, written once
            read = _nbytes(args[1:]) + _nbytes(kwargs)
            written = min(written, read) if read else written
        else:
            read = _nbytes(args) + _nbytes(kwargs)
        self.bytes += read + written
        return out


def kernel_work(flops: float, nbytes: float) -> None:
    """Credit one kernel call's work to every counting pass in progress:
    a kernel wrapper's fake branch calls this in place of a launch."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, _WorkCounter):
            mode.flops += float(flops)
            mode.bytes += float(nbytes)


def _fakes(tree, mode: FakeTensorMode):
    """``tree`` with every tensor leaf replaced by a fake of it."""
    if isinstance(tree, torch.Tensor):
        return mode.from_tensor(tree)
    if isinstance(tree, dict):
        return {k: _fakes(v, mode) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fakes(x, mode) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fakes(x, mode) for x in tree)
    return tree


def _signature(tree, out: list) -> list:
    """Hashable (shape, dtype, device) signature of an argument tree."""
    if isinstance(tree, torch.Tensor):
        out.append((tuple(tree.shape), str(tree.dtype), str(tree.device)))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _signature(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _signature(x, out)
    elif isinstance(tree, torch.Generator):
        out.append(("Generator", str(tree.device)))
    elif isinstance(tree, (bool, int, float)):
        # a scalar argument (a step count, a valid-row count) is a 0-d
        # array in the reference's signature: its type, not its value
        out.append((type(tree).__name__,))
    else:
        out.append((type(tree).__name__, repr(tree)[:32]))
    return out


def count_work(fn, *args) -> tuple[float, float]:
    """(flops, bytes) of ``fn(*args)`` counted on fake copies of the
    arguments; nothing runs on the device and no argument changes."""
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    counter = _WorkCounter()
    with fake_mode:
        fake_args = _fakes(args, fake_mode)
        with counter:
            fn(*fake_args)
    return counter.flops, counter.bytes


class CostModel:
    """Caches per-signature cost; publishes utilization gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cache: dict[tuple, CostInfo | None] = {}
        self._by_key: dict[str, CostInfo] = {}

    # ------------------------------------------------------------- capture
    def capture(self, key: str, fn, *args,
                analytic_flops: float | None = None) -> CostInfo | None:
        """Cost of ``fn(*args)`` for these argument shapes, counted on fake
        tensors (cached per signature).  Never raises; returns None when
        nothing could be counted and no ``analytic_flops`` fallback was
        given."""
        if not core.enabled():
            return None
        try:
            sig = (key,) + tuple(_signature(args, []))
        except Exception:
            return None
        with self._lock:
            if sig in self._cache:
                info = self._cache[sig]
                if info is not None:
                    self._by_key[key] = info
                return info
        info = None
        try:
            flops, nbytes = count_work(fn, *args)
            if flops > 0:
                info = CostInfo(flops, nbytes, "counted")
        except Exception:
            info = None
        if info is None and analytic_flops is not None and analytic_flops > 0:
            info = CostInfo(float(analytic_flops), 0.0, "analytic")
        with self._lock:
            self._cache[sig] = info
            if info is not None:
                self._by_key[key] = info
        return info

    def put(self, key: str, info: CostInfo) -> None:
        """Install an externally computed cost under ``key``."""
        with self._lock:
            self._by_key[key] = info

    def get(self, key: str) -> CostInfo | None:
        """Most recently captured cost for ``key`` (any signature)."""
        with self._lock:
            return self._by_key.get(key)

    # ------------------------------------------------------------- peaks
    def peak_flops(self) -> float | None:
        return _lookup(PEAK_FLOPS, _device_kind())

    def peak_bytes_per_s(self) -> float | None:
        return _lookup(PEAK_BYTES_PER_S, _device_kind())

    # ------------------------------------------------------------- publish
    def publish_utilization(self, info: CostInfo | None, seconds: float,
                            mfu_gauge: str, mbu_gauge: str | None = None,
                            registry=None) -> float | None:
        """Gauge ``mfu_gauge`` (and ``mbu_gauge`` when bytes are known)
        from one execution's cost and measured wall seconds.  Returns the
        MFU value, or None when nothing could be published."""
        if info is None or not (seconds > 0) or not core.enabled():
            return None
        reg = registry if registry is not None else METRICS
        mfu = None
        peak_f = self.peak_flops()
        if peak_f and info.flops > 0:
            mfu = info.flops / (seconds * peak_f)
            if math.isfinite(mfu):
                reg.gauge(mfu_gauge, mfu)
            else:
                mfu = None
        peak_b = self.peak_bytes_per_s()
        if mbu_gauge and peak_b and info.bytes_accessed > 0:
            mbu = info.bytes_accessed / (seconds * peak_b)
            if math.isfinite(mbu):
                reg.gauge(mbu_gauge, mbu)
        return mfu

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._by_key.clear()


COSTS = CostModel()
