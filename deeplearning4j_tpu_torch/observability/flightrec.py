"""Failure flight recorder: bounded rings of recent activity, dumped to a
timestamped JSON bundle when something goes wrong.

Port of ``deeplearning4j_tpu/observability/flightrec.py``.  The recorder
listens to the tracer (every completed span) and the process-wide metrics
registry (counter/gauge mutations; chaos-site fires arrive as
``faults.injected.<site>`` increments), keeping only the last few hundred
entries.  On a failure — ``DivergenceError``, a supervisor retry, a
corrupt checkpoint, a serving 429 burst — ``dump(trigger, extra=...)``
writes everything plus a metrics snapshot to
``<dump_dir>/flightrec-<trigger>-<ms>-<seq>.json`` (``dump_dir`` defaults
to ``$DL4J_TPU_FLIGHTREC_DIR``, else ``flightrec`` under the working
directory), so the moments before the failure survive it.

Every record method returns before taking the lock while observability
is disabled.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any

from . import core
from .metrics import METRICS
from .tracing import TRACER

_SPAN_RING = 256
_METRIC_RING = 512
_FAULT_RING = 64
_429_RING = 64
_SPILL_RING = 64


class FlightRecorder:
    """Bounded rings of recent spans / metric deltas / chaos fires."""

    def __init__(self, dump_dir: str | Path | None = None):
        self._lock = threading.Lock()
        self.spans: deque[dict[str, Any]] = deque(maxlen=_SPAN_RING)
        self.metric_events: deque[tuple[str, str, float]] = deque(
            maxlen=_METRIC_RING)
        self.faults: deque[dict[str, Any]] = deque(maxlen=_FAULT_RING)
        self._429s: deque[float] = deque(maxlen=_429_RING)
        self._last_burst_dump = 0.0
        self.burst_n = 8            # 429s ...
        self.burst_window_s = 2.0   # ... within this window -> dump
        self.burst_cooldown_s = 30.0
        self._spills: deque[tuple[float, str]] = deque(maxlen=_SPILL_RING)
        self._last_spill_dump = 0.0
        self.spill_burst_n = 8          # spillovers ...
        self.spill_window_s = 2.0       # ... within this window -> dump
        self.spill_cooldown_s = 30.0
        self.dump_dir = Path(
            dump_dir if dump_dir is not None
            else os.environ.get("DL4J_TPU_FLIGHTREC_DIR", "flightrec"))
        self._seq = 0

    # ------------------------------------------------------------- listeners
    def record_span(self, ev: dict[str, Any]) -> None:
        """Tracer listener: keep a compact copy of each completed span."""
        if not core.enabled():
            return
        args = ev.get("args") or {}
        rec = {"name": ev["name"], "ts": ev["ts"], "dur": ev["dur"],
               "trace_id": args.get("trace_id")}
        err = args.get("error")
        if err:
            rec["error"] = err
        step = args.get("step")
        if step is not None:
            rec["step"] = step
        with self._lock:
            self.spans.append(rec)

    def record_metric(self, kind: str, name: str, value: float) -> None:
        """Registry listener: counter/gauge deltas; chaos-site fires show
        up as ``faults.injected.<site>`` counter increments."""
        if not core.enabled():
            return
        with self._lock:
            self.metric_events.append((kind, name, value))
            if name.startswith("faults.injected."):
                self.faults.append({"site": name[len("faults.injected."):],
                                    "time": time.time()})

    # ------------------------------------------------------------- triggers
    def note_429(self) -> Path | None:
        """Record one backpressure rejection; dump on a burst (``burst_n``
        within ``burst_window_s``, rate-limited by ``burst_cooldown_s``)."""
        if not core.enabled():
            return None
        now = time.monotonic()
        with self._lock:
            self._429s.append(now)
            burst = (len(self._429s) >= self.burst_n
                     and now - self._429s[-self.burst_n] <= self.burst_window_s
                     and now - self._last_burst_dump >= self.burst_cooldown_s)
            if burst:
                self._last_burst_dump = now
        if burst:
            return self.dump("serving_429_burst",
                             extra={"rejections_in_window": self.burst_n,
                                    "window_s": self.burst_window_s})
        return None

    def note_spillover(self, replica: str) -> Path | None:
        """Record one router spillover (a request shed off its affinity
        replica).  A burst — ``spill_burst_n`` within ``spill_window_s``
        — means a replica is effectively unavailable while still admitting
        probes, so dump a bundle naming the replicas that shed, rate-
        limited like :meth:`note_429`."""
        if not core.enabled():
            return None
        now = time.monotonic()
        with self._lock:
            self._spills.append((now, replica))
            burst = (len(self._spills) >= self.spill_burst_n
                     and now - self._spills[-self.spill_burst_n][0]
                     <= self.spill_window_s
                     and now - self._last_spill_dump >= self.spill_cooldown_s)
            if burst:
                self._last_spill_dump = now
                recent = [r for _, r in self._spills]
            else:
                recent = []
        if burst:
            return self.dump("router_spillover_burst",
                             extra={"spillovers_in_window": self.spill_burst_n,
                                    "window_s": self.spill_window_s,
                                    "recent_replicas": recent})
        return None

    # ------------------------------------------------------------- dump
    def dump(self, trigger: str, extra: dict[str, Any] | None = None
             ) -> Path | None:
        """Write the rings + a metrics snapshot to a timestamped bundle.
        Never raises (a broken disk must not mask the original failure)."""
        if not core.enabled():
            return None
        try:
            with self._lock:
                self._seq += 1
                bundle = {
                    "trigger": trigger,
                    "time": time.time(),
                    "spans": list(self.spans),
                    "metric_events": [list(e) for e in self.metric_events],
                    "faults": list(self.faults),
                    "extra": extra or {},
                }
                seq = self._seq
            bundle["metrics"] = METRICS.snapshot()
            self.dump_dir.mkdir(parents=True, exist_ok=True)
            name = f"flightrec-{trigger}-{int(time.time() * 1000)}-{seq}.json"
            path = self.dump_dir / name
            path.write_text(json.dumps(bundle, default=str))
            return path
        except Exception:
            return None

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.metric_events.clear()
            self.faults.clear()
            self._429s.clear()
            self._last_burst_dump = 0.0
            self._spills.clear()
            self._last_spill_dump = 0.0


FLIGHTREC = FlightRecorder()

# Passive wiring: the recorder sees every completed span and every
# counter/gauge mutation for the life of the process.
TRACER.add_listener(FLIGHTREC.record_span)
METRICS.add_listener(FLIGHTREC.record_metric)
