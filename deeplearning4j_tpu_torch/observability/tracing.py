"""Span-based structured tracing.

Port of ``deeplearning4j_tpu/observability/tracing.py``.
``with trace.span("train_step", step=i):`` opens a nestable span; nesting
propagates through a ``contextvars.ContextVar``, so spans opened on worker
threads attribute to the right parent.  Completed spans land in a bounded
in-memory buffer and (optionally) stream to a JSONL event log.  The buffer
exports as Chrome trace-event JSON — complete (``"ph": "X"``) events with
microsecond ``ts``/``dur``, ``pid`` = the ``torch.distributed`` rank (0
without a process group), ``tid`` = the OS thread id — loadable in
Perfetto.

Distributed identity: every span carries a ``trace_id``, a ``span_id`` and
a ``parent_id``.  A span inherits identity from its enclosing span, else
from the ambient context set by :func:`bind` (after parsing a W3C
``traceparent`` header at a process boundary), else mints a fresh trace.
:func:`current_traceparent` renders the context for outbound HTTP;
:func:`record_span` records a span with an explicit start and duration,
for code that multiplexes many logical requests on one thread.

Device time: ``span(name, device=t)`` also times the work the span
enqueues on tensor ``t``'s device.  On a CUDA tensor two CUDA events from
a pool the tracer allocates once per device bracket the span on the
current stream; the span lands in the buffer once its end event has
completed, with a ``device_ms`` argument beside its host ``ts``/``dur``.
Nothing waits for it: the next device-timed span's entry polls
``query()``, and :meth:`Tracer.drain` does the same for readers.  With
the pool exhausted the span keeps its host timing alone (counted on
``trace.dropped_events``).  On a CPU tensor ``device_ms`` is the host
duration (CPU ops run synchronously).  A fake tensor (a cost count) or a
stream capturing a CUDA graph records nothing.  A device-timed span
opened on a thread with no open span (autograd's device thread, which
runs a CUDA backward) joins the span :meth:`Tracer.adopting` names.  A
resolved ``kernel.<kind>.<phase>`` span is one observation of the
``kernel.<kind>.<phase>`` time histogram (``kernels.record_kernel_time``).

One clock with the device trace: while a ``torch.profiler`` session
records, every span also enters it as a range of the span's name (a
function-scope ``RecordFunction``: no device-side annotation, so it is
never counted as device work), and the Chrome export carries
``ts_origin_unix_ns``, the profiler-clock time of ``ts`` 0, so the two
exports lay over each other.

When observability is disabled, ``span()`` returns the shared no-op
context manager (no allocation); see ``core``.  :func:`profiler_trace` is
the device-level companion: a ``torch.profiler`` session.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import random
import sys
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable

from . import core

_EPOCH = time.perf_counter()
_MAX_EVENTS = 65536
#: CUDA events a tracer allocates per device, two for each device-timed
#: span in flight (a step of the LM holds about 130 for a few ms)
_DEVICE_EVENTS = 2048
#: spans a device-timed span's entry resolves at most: each entry adds one
#: span and takes up to this many, so none piles up, and a step's first
#: entry (where the host may pace the device) does not resolve a whole
#: step's spans at once
_RESOLVE_AT_ENTRY = 4

# innermost open span, per context (thread / task)
_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "dl4j_tpu_torch_current_span", default=None)

# ambient (trace_id, parent_span_id) installed by ``bind()``, consulted
# when no span is open in this context
_trace_ctx: contextvars.ContextVar[tuple[str, str] | None] = (
    contextvars.ContextVar("dl4j_tpu_torch_trace_ctx", default=None))

_process_index: int | None = None

# ids need uniqueness, not cryptographic strength
_rng = random.Random()


def new_trace_id() -> str:
    """Fresh 32-hex-char W3C trace id (non-zero)."""
    return f"{_rng.getrandbits(128) | 1:032x}"


def new_span_id() -> str:
    """Fresh 16-hex-char W3C span id (non-zero)."""
    return f"{_rng.getrandbits(64) | 1:016x}"


def current_trace_context() -> tuple[str, str] | None:
    """(trace_id, span_id) of the innermost open span, else the ambient
    bound context, else None."""
    sp = _current.get()
    if sp is not None and sp.trace_id:
        return (sp.trace_id, sp.span_id)
    return _trace_ctx.get()


def current_traceparent() -> str | None:
    """W3C ``traceparent`` header value for the current context, or None."""
    ctx = current_trace_context()
    if ctx is None:
        return None
    return f"00-{ctx[0]}-{ctx[1]}-01"


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """Parse ``00-<32hex>-<16hex>-<2hex>`` → (trace_id, parent_span_id).

    Returns None for anything malformed (wrong field count or width,
    non-hex, all-zero ids): a bad inbound header means "mint fresh",
    never an error."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
            return None
        int(version, 16)
    except ValueError:
        return None
    return (trace_id.lower(), span_id.lower())


@contextlib.contextmanager
def bind(trace_id: str | None, parent_id: str | None = None):
    """Install an ambient trace context for the dynamic extent; spans
    opened inside inherit it.  No-op when ``trace_id`` is falsy."""
    if not trace_id:
        yield
        return
    token = _trace_ctx.set((trace_id, parent_id or ""))
    try:
        yield
    finally:
        _trace_ctx.reset(token)


def _pid() -> int:
    """The ``torch.distributed`` rank, resolved once; 0 without a process
    group."""
    global _process_index
    if _process_index is None:
        try:
            import torch.distributed as dist
            _process_index = (int(dist.get_rank())
                              if dist.is_available() and dist.is_initialized()
                              else 0)
        except Exception:
            _process_index = 0
    return _process_index


def _mirror(name: str):
    """A ``torch.profiler`` range named ``name``, entered, while a profiler
    session records; else None.  Function scope, so the profiler puts no
    annotation of it on the device's timeline."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return None
    import torch

    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


def clock_anchor_ns() -> int:
    """Unix-epoch nanoseconds at ``ts`` 0 of this process's spans: the
    clock ``torch.profiler`` stamps its events with (their ``start_ns``;
    its Chrome export's ``ts`` counts microseconds from the export's
    ``baseTimeNanoseconds``).  The tightest of a few readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, unix - (a + b) // 2)
    return best[1] + round(_EPOCH * 1e9)


def host_ts_us(t: float) -> float:
    """The span ``ts`` (µs) of a ``time.perf_counter()`` reading."""
    return (t - _EPOCH) * 1e6


class Span:
    """One nestable timed region.  Use via ``tracer.span(...)``."""

    __slots__ = ("tracer", "name", "attrs", "parent", "depth",
                 "t0_us", "tid", "_token", "_range",
                 "trace_id", "span_id", "parent_id")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.parent: Span | None = None
        self.depth = 0
        self.trace_id = ""
        self.span_id = ""
        self.parent_id = ""

    def set(self, **attrs) -> None:
        """Attach/override attributes while the span is open."""
        self.attrs.update(attrs)

    def _parent(self) -> "Span | None":
        return _current.get()

    def __enter__(self) -> "Span":
        self.parent = self._parent()
        self.depth = self.parent.depth + 1 if self.parent is not None else 0
        if self.parent is not None and self.parent.trace_id:
            self.trace_id = self.parent.trace_id
            self.parent_id = self.parent.span_id
        else:
            ctx = _trace_ctx.get()
            if ctx is not None:
                self.trace_id, self.parent_id = ctx
            else:
                self.trace_id = new_trace_id()
        self.span_id = new_span_id()
        self._token = _current.set(self)
        self.tid = threading.get_ident()
        self._range = _mirror(self.name)
        self.t0_us = (time.perf_counter() - _EPOCH) * 1e6
        return self

    def _close(self, exc_type) -> float:
        """Stop the host clock; returns the duration in µs."""
        dur_us = (time.perf_counter() - _EPOCH) * 1e6 - self.t0_us
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _current.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        return dur_us

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.tracer._record(self, self._close(exc_type))
        return False


class _DeviceSpan(Span):
    """A span that also times its device's work (``Tracer.span(...,
    device=t)``): two pooled CUDA events on the current stream of a CUDA
    device, resolved later; the host duration on the CPU."""

    __slots__ = ("device", "stream", "events")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict[str, Any],
                 device):
        super().__init__(tracer, name, attrs)
        self.device = device
        self.stream = None
        self.events = None

    def _parent(self) -> "Span | None":
        parent = _current.get()
        if parent is None and _trace_ctx.get() is None:
            return self.tracer._adopter
        return parent

    def __enter__(self) -> "Span":
        tracer = self.tracer
        tracer.drain(_RESOLVE_AT_ENTRY)
        super().__enter__()
        if self.device.type == "cuda":
            self.events = tracer._device_events.take(self.device)
            if self.events is not None:
                import torch

                self.stream = torch.cuda.current_stream(self.device)
                self.events[0].record(self.stream)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.events is not None:
            self.events[1].record(self.stream)
        dur_us = self._close(exc_type)
        if self.device.type != "cuda":
            self.tracer._record(self, dur_us, device_ms=dur_us / 1e3)
        elif self.events is None:
            self.tracer._record(self, dur_us)
        else:
            self.tracer._device_events.wait(self, dur_us)
        return False


class _DeviceEvents:
    """The CUDA events of a tracer's device-timed spans: ``size`` for each
    device, made at its first span, and the spans whose end event may not
    have completed, in the order they closed."""

    def __init__(self, size: int):
        self.size = size
        self._lock = threading.Lock()
        self._free: dict[int, list] = {}
        self._waiting: deque = deque()

    def take(self, device):
        """A (start, end) pair of ``device``, or None (counted) when its
        pool is exhausted."""
        with self._lock:
            free = self._free.get(device.index)
            if free is None:
                import torch

                free = self._free[device.index] = [
                    torch.cuda.Event(enable_timing=True)
                    for _ in range(self.size)]
            if len(free) >= 2:
                return free.pop(), free.pop()
        from . import metrics
        metrics.METRICS.increment("trace.dropped_events")
        return None

    def wait(self, span: _DeviceSpan, dur_us: float) -> None:
        with self._lock:
            self._waiting.append((span, dur_us))

    def ready(self, limit: int | None = None) -> tuple[list, int]:
        """``([(span, host µs, device ms)], still waiting)``: the oldest
        spans whose end event has completed, up to the first that has not
        (``query()``; the host never waits), at most ``limit``."""
        done = []
        with self._lock:
            while self._waiting and (limit is None or len(done) < limit):
                span, dur_us = self._waiting[0]
                start, end = span.events
                if not end.query():
                    break
                self._waiting.popleft()
                done.append((span, dur_us, start.elapsed_time(end)))
                self._free[span.device.index] += (start, end)
                span.events = None
            return done, len(self._waiting)

    def forget(self) -> None:
        """Drop the waiting spans and take their events back."""
        with self._lock:
            for span, _ in self._waiting:
                self._free[span.device.index] += span.events
                span.events = None
            self._waiting.clear()


def _timed_device(t):
    """The device a span on tensor ``t`` times, or None where it records
    nothing: a fake tensor (a cost count) or a stream capturing a CUDA
    graph."""
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(t):
        return None
    if t.device.type == "cuda":
        import torch

        if torch.cuda.is_current_stream_capturing():
            return None
    return t.device


class Tracer:
    """Collects completed spans; exports Chrome trace JSON and JSONL."""

    def __init__(self, max_events: int = _MAX_EVENTS):
        self._lock = threading.Lock()
        self.events: deque[dict[str, Any]] = deque(maxlen=max_events)
        self.dropped = 0  # spans evicted from the bounded ring
        self._jsonl: Any = None  # open file handle while streaming
        self._listeners: list[Callable[[dict[str, Any]], None]] = []
        self._device_events = _DeviceEvents(_DEVICE_EVENTS)
        self._adopter: Span | None = None

    def span(self, name: str, *, device=None, **attrs):
        """Open a span context manager (no-op singleton when disabled).
        With ``device``, a tensor, the span also times the work on its
        device (``device_ms``; the module docstring says how); on a fake
        tensor or under CUDA-graph capture it is the no-op singleton."""
        if not core.enabled():
            return core.NOOP_SPAN
        if device is None:
            return Span(self, name, attrs)
        dev = _timed_device(device)
        if dev is None:
            return core.NOOP_SPAN
        return _DeviceSpan(self, name, attrs, dev)

    @contextlib.contextmanager
    def adopting(self, span):
        """While the block runs, a device-timed span opened on a thread
        with no open span and no bound context joins ``span``: work the
        block hands to other threads and waits for, as autograd runs a
        CUDA backward on its device thread.  No-op for the no-op span."""
        if not isinstance(span, Span):
            yield
            return
        prev, self._adopter = self._adopter, span
        try:
            yield
        finally:
            self._adopter = prev

    def drain(self, limit: int | None = None) -> int:
        """Record the device-timed spans whose work has completed (at most
        ``limit``), oldest first, without waiting for the device; returns
        how many still wait."""
        done, waiting = self._device_events.ready(limit)
        for span, dur_us, device_ms in done:
            self._record(span, dur_us, device_ms)
        return waiting

    def add_listener(self, fn: Callable[[dict[str, Any]], None]) -> None:
        """Call ``fn(event)`` for every completed span (flight recorder)."""
        self._listeners.append(fn)

    def _record(self, span: Span, dur_us: float,
                device_ms: float | None = None) -> None:
        args = dict(span.attrs,
                    parent=span.parent.name if span.parent else None,
                    depth=span.depth,
                    trace_id=span.trace_id,
                    span_id=span.span_id,
                    parent_span_id=span.parent_id or None)
        if device_ms is not None:
            args["device_ms"] = device_ms
        self._append({
            "name": span.name,
            "ph": "X",
            "ts": span.t0_us,
            "dur": dur_us,
            "pid": _pid(),
            "tid": span.tid,
            "args": args,
        })
        if device_ms is not None and span.name.startswith("kernel."):
            from .kernels import record_kernel_time
            kind, _, phase = span.name[len("kernel."):].partition(".")
            record_kernel_time(kind, phase, device_ms / 1e3)

    def record_span(self, name: str, t0_s: float, dur_s: float, *,
                    trace_id: str | None = None,
                    parent_id: str | None = None,
                    span_id: str | None = None,
                    tid: int | None = None,
                    **attrs) -> str | None:
        """Record a span with an explicit ``time.perf_counter()`` start and
        duration (seconds).  Returns the span id (for parenting children),
        or None when disabled."""
        if not core.enabled():
            return None
        sid = span_id or new_span_id()
        self._append({
            "name": name,
            "ph": "X",
            "ts": (t0_s - _EPOCH) * 1e6,
            "dur": max(dur_s, 0.0) * 1e6,
            "pid": _pid(),
            "tid": tid if tid is not None else threading.get_ident(),
            "args": dict(attrs,
                         parent=None,
                         depth=0,
                         trace_id=trace_id or new_trace_id(),
                         span_id=sid,
                         parent_span_id=parent_id or None),
        })
        return sid

    def _append(self, ev: dict[str, Any]) -> None:
        with self._lock:
            dropped_one = len(self.events) == self.events.maxlen
            if dropped_one:
                self.dropped += 1
            self.events.append(ev)
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(ev) + "\n")
                self._jsonl.flush()
        # outside the tracer lock: the registry and the flight recorder
        # take their own locks
        if dropped_one:
            from . import metrics
            metrics.METRICS.increment("trace.dropped_events")
        for fn in self._listeners:
            try:
                fn(ev)
            except Exception:
                pass

    def to_chrome_trace(self) -> dict[str, Any]:
        """Perfetto/chrome://tracing-loadable trace object."""
        with self._lock:
            return {"traceEvents": list(self.events),
                    "displayTimeUnit": "ms",
                    "metadata": {"dropped": self.dropped,
                                 "ts_origin_unix_ns": clock_anchor_ns()}}

    def save_chrome_trace(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.to_chrome_trace()))
        return path

    def export_jsonl(self, path: str | Path) -> Path:
        """Dump the buffered events as one JSON object per line."""
        path = Path(path)
        with self._lock:
            with open(path, "w") as f:
                for ev in self.events:
                    f.write(json.dumps(ev) + "\n")
        return path

    def stream_jsonl(self, path: str | Path) -> None:
        """Append each completed span to ``path`` as it closes (an event
        log that survives a process that never reaches export)."""
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
            self._jsonl = open(path, "a")

    def stop_stream(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped = 0
        self._device_events.forget()


TRACER = Tracer()


def span(name: str, *, device=None, **attrs):
    """Module-level convenience: ``with trace.span("fit", epochs=2):``;
    ``device=t`` times ``t``'s device too (``Tracer.span``)."""
    return TRACER.span(name, device=device, **attrs)


def adopting(span):
    """Module-level convenience for ``TRACER.adopting``."""
    return TRACER.adopting(span)


def record_span(name: str, t0_s: float, dur_s: float, **kw) -> str | None:
    """Module-level convenience for ``TRACER.record_span``."""
    return TRACER.record_span(name, t0_s, dur_s, **kw)


def profiler_trace(log_dir: str):
    """Context manager: a ``torch.profiler`` session over the CPU and (when
    there is one) the GPU, written to ``log_dir`` as a Chrome trace for
    TensorBoard or Perfetto — the device-level companion to the host-side
    spans above."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(str(log_dir)))
