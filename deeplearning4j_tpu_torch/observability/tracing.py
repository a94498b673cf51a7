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

When observability is disabled, ``span()`` returns the shared no-op
context manager (no allocation); see ``core``.  :func:`profiler_trace` is
the device-level companion: a ``torch.profiler`` session.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import random
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable

from . import core

_EPOCH = time.perf_counter()
_MAX_EVENTS = 65536

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


class Span:
    """One nestable timed region.  Use via ``tracer.span(...)``."""

    __slots__ = ("tracer", "name", "attrs", "parent", "depth",
                 "t0_us", "tid", "_token",
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

    def __enter__(self) -> "Span":
        self.parent = _current.get()
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
        self.t0_us = (time.perf_counter() - _EPOCH) * 1e6
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_us = (time.perf_counter() - _EPOCH) * 1e6 - self.t0_us
        _current.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.tracer._record(self, dur_us)
        return False


class Tracer:
    """Collects completed spans; exports Chrome trace JSON and JSONL."""

    def __init__(self, max_events: int = _MAX_EVENTS):
        self._lock = threading.Lock()
        self.events: deque[dict[str, Any]] = deque(maxlen=max_events)
        self.dropped = 0  # spans evicted from the bounded ring
        self._jsonl: Any = None  # open file handle while streaming
        self._listeners: list[Callable[[dict[str, Any]], None]] = []

    def span(self, name: str, **attrs):
        """Open a span context manager (no-op singleton when disabled)."""
        if not core.enabled():
            return core.NOOP_SPAN
        return Span(self, name, attrs)

    def add_listener(self, fn: Callable[[dict[str, Any]], None]) -> None:
        """Call ``fn(event)`` for every completed span (flight recorder)."""
        self._listeners.append(fn)

    def _record(self, span: Span, dur_us: float) -> None:
        self._append({
            "name": span.name,
            "ph": "X",
            "ts": span.t0_us,
            "dur": dur_us,
            "pid": _pid(),
            "tid": span.tid,
            "args": dict(span.attrs,
                         parent=span.parent.name if span.parent else None,
                         depth=span.depth,
                         trace_id=span.trace_id,
                         span_id=span.span_id,
                         parent_span_id=span.parent_id or None),
        })

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
                    "metadata": {"dropped": self.dropped}}

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


TRACER = Tracer()


def span(name: str, **attrs):
    """Module-level convenience: ``with trace.span("fit", epochs=2):``."""
    return TRACER.span(name, **attrs)


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
