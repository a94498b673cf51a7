"""Observability of the port: structured tracing, metrics, the flight
recorder, goodput accounting and device-memory gauges.

- ``trace`` (module alias) / ``span`` — nestable spans with trace
  identity and W3C ``traceparent`` propagation, Chrome-trace and JSONL
  export (``tracing``); ``profiler_trace`` wraps ``torch.profiler``
- ``METRICS`` / ``MetricsRegistry`` — counters, gauges, timing
  histograms with p50/p95/p99, Prometheus text (``metrics``)
- ``FLIGHTREC`` — bounded rings of recent spans, metric deltas and chaos
  fires, dumped to a JSON bundle on failure triggers (``flightrec``)
- ``GoodputTracker`` — wall-clock state accounting for supervised runs
  (``goodput``)
- ``sample_device_memory`` / ``sample_state_bytes`` — per-device memory
  gauges (``device``)
- ``enabled`` / ``enable`` / ``disable`` — the process-wide flag; no
  per-step allocation while off (``core``)

Cost models, SLOs, time series, fleet federation and the status server
are not ported yet (``ROADMAP.md`` A7).
"""

from . import tracing as trace
from .core import NOOP_SPAN, disable, enable, enabled
from .device import sample_device_memory, sample_state_bytes
from .flightrec import FLIGHTREC, FlightRecorder
from .goodput import GoodputTracker
from .metrics import (DEFAULT_TIME_BUCKETS, METRICS, Histogram,
                      MetricsRegistry, StepTimer)
from .tracing import TRACER, Tracer, profiler_trace, span

__all__ = [
    "DEFAULT_TIME_BUCKETS", "FLIGHTREC", "FlightRecorder", "GoodputTracker",
    "Histogram", "METRICS", "MetricsRegistry", "NOOP_SPAN", "StepTimer",
    "TRACER", "Tracer", "disable", "enable", "enabled", "profiler_trace",
    "sample_device_memory", "sample_state_bytes", "span", "trace",
]
