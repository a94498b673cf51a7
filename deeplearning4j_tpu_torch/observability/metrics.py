"""Metrics: counters, gauges and bucketed timing histograms.

Port of ``deeplearning4j_tpu/observability/metrics.py``: every timer is a
``Histogram`` with Prometheus-style cumulative buckets plus a bounded
window of raw values for percentile snapshots (p50/p95/p99), and a
registry renders to a JSON ``snapshot`` and to Prometheus text
(``to_prometheus``).  All mutation goes through the registry lock, and
every mutator returns before taking it while observability is disabled
(``core.disable()``).

:data:`METRICS` is the process-wide registry the trainer, the checkpoint
manager, the supervisor and the fault injector publish to.  The serving
engine still publishes to a registry of its own (``ROADMAP.md`` A7).
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict, deque
from typing import Any, Iterable

from . import core

#: default buckets for timings in seconds: 0.5 ms .. 60 s
DEFAULT_TIME_BUCKETS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: raw values kept per histogram for percentiles (the most recent ones);
#: ``DL4J_TPU_HIST_WINDOW`` sets it for long runs
ENV_HIST_WINDOW = "DL4J_TPU_HIST_WINDOW"
WINDOW = max(16, int(os.environ.get(ENV_HIST_WINDOW, "4096") or "4096"))


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class Histogram:
    """Cumulative-bucket histogram + bounded raw-value window (not locked
    itself: the owning registry serializes access)."""

    __slots__ = ("buckets", "bucket_counts", "count", "total", "values",
                 "dropped")

    def __init__(self, buckets: Iterable[float] = DEFAULT_TIME_BUCKETS,
                 window: int | None = None):
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * len(self.buckets)
        self.count = 0
        self.total = 0.0
        self.values: deque[float] = deque(maxlen=window or WINDOW)
        self.dropped = 0  # raw values evicted from the percentile window

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if len(self.values) == self.values.maxlen:
            self.dropped += 1
        self.values.append(value)
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.bucket_counts[i] += 1
                break

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """[(upper_bound, cumulative_count)]; the +Inf row is ``count``."""
        out, acc = [], 0
        for ub, c in zip(self.buckets, self.bucket_counts):
            acc += c
            out.append((ub, acc))
        return out

    def summary(self) -> dict[str, float]:
        vals = sorted(self.values)
        return {
            "count": self.count,
            "total_s": self.total,
            "mean_s": self.total / self.count if self.count else 0.0,
            "p50_s": _percentile(vals, 0.50),
            "p95_s": _percentile(vals, 0.95),
            "p99_s": _percentile(vals, 0.99),
            "max_s": vals[-1] if vals else float("nan"),
            "dropped": self.dropped,
        }


class _Timer:
    """``with registry.time(name):`` — observes elapsed seconds on exit."""

    __slots__ = ("registry", "name", "t0")

    def __init__(self, registry: "MetricsRegistry", name: str):
        self.registry = registry
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.registry.observe_time(self.name, time.perf_counter() - self.t0)
        return False


def _prom_name(name: str) -> str:
    """Dotted registry names -> Prometheus metric names."""
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


def _prom_float(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    return repr(float(v))


class MetricsRegistry:
    """Named counters/gauges/timing-histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.timers: dict[str, Histogram] = {}
        # fn(kind, name, value) after each counter/gauge mutation, outside
        # the registry lock (the flight recorder takes its own); timing
        # observations are not forwarded
        self._listeners: list = []

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def _notify(self, kind: str, name: str, value: float) -> None:
        for fn in self._listeners:
            try:
                fn(kind, name, value)
            except Exception:
                pass

    def increment(self, name: str, by: float = 1.0) -> None:
        if not core.enabled():
            return
        with self._lock:
            self.counters[name] += by
        if self._listeners:
            self._notify("counter", name, by)

    def gauge(self, name: str, value: float) -> None:
        if not core.enabled():
            return
        with self._lock:
            self.gauges[name] = value
        if self._listeners:
            self._notify("gauge", name, value)

    def observe_time(self, name: str, seconds: float,
                     buckets: Iterable[float] | None = None) -> None:
        """Record one timing observation under the registry lock."""
        self.observe_many(name, (seconds,), buckets)

    def observe_many(self, name: str, values: Iterable[float],
                     buckets: Iterable[float] | None = None) -> None:
        """Record a batch of observations under one lock acquisition."""
        if not core.enabled():
            return
        with self._lock:
            h = self.timers.get(name)
            if h is None:
                h = self.timers[name] = Histogram(buckets or DEFAULT_TIME_BUCKETS)
            for v in values:
                h.observe(v)

    def time(self, name: str):
        """Context manager timing its body into the ``name`` histogram."""
        if not core.enabled():
            return core.NOOP_SPAN
        return _Timer(self, name)

    def reset(self) -> None:
        """Drop all recorded state."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.timers.clear()

    def _counters_locked(self) -> dict[str, float]:
        counters = dict(self.counters)
        dropped = sum(h.dropped for h in self.timers.values())
        if dropped:
            counters["metrics.dropped_samples"] = float(dropped)
        return counters

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "counters": self._counters_locked(),
                "gauges": dict(self.gauges),
                "timers": {k: h.summary() for k, h in self.timers.items()
                           if h.count},
            }

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4): counters get a
        ``_total`` suffix, timers render as histograms in seconds."""
        lines: list[str] = []
        with self._lock:
            counters = self._counters_locked()
            for name in sorted(counters):
                pn = _prom_name(name)
                if not pn.endswith("_total"):
                    pn += "_total"
                lines.append(f"# TYPE {pn} counter")
                lines.append(f"{pn} {_prom_float(counters[name])}")
            for name in sorted(self.gauges):
                pn = _prom_name(name)
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {_prom_float(self.gauges[name])}")
            for name in sorted(self.timers):
                h = self.timers[name]
                pn = _prom_name(name)
                if not pn.endswith("_seconds"):
                    pn += "_seconds"
                lines.append(f"# TYPE {pn} histogram")
                for ub, acc in h.cumulative_buckets():
                    lines.append(f'{pn}_bucket{{le="{_prom_float(ub)}"}} {acc}')
                lines.append(f'{pn}_bucket{{le="+Inf"}} {h.count}')
                lines.append(f"{pn}_sum {_prom_float(h.total)}")
                lines.append(f"{pn}_count {h.count}")
        return "\n".join(lines) + "\n"


METRICS = MetricsRegistry()


class StepTimer:
    """Iteration listener recording each iteration's wall time (through
    the locked ``observe_time``) and the model's score, if it has one."""

    def __init__(self, registry: MetricsRegistry = METRICS,
                 name: str = "train_step"):
        self.registry = registry
        self.name = name
        self._last = None

    def iteration_done(self, model, iteration: int) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.registry.observe_time(self.name, now - self._last)
        self._last = now
        self.registry.increment(f"{self.name}.iterations")
        if hasattr(model, "score"):
            try:
                self.registry.gauge(f"{self.name}.score",
                                    float(model.score()))
            except Exception:
                pass
