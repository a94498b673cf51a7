"""Observability of the port: structured tracing, metrics, cost and
utilization, the flight recorder, time series, SLOs, fleet federation,
goodput accounting, device-memory gauges and the status server.

- ``trace`` (module alias) / ``span`` — nestable spans with trace
  identity and W3C ``traceparent`` propagation, Chrome-trace and JSONL
  export (``tracing``); ``profiler_trace`` wraps ``torch.profiler``
- ``METRICS`` / ``MetricsRegistry`` — counters, gauges, timing
  histograms with p50/p95/p99, Prometheus text (``metrics``)
- ``COSTS`` / ``CostModel`` — flops and bytes of a function counted on
  fake tensors; live ``*.mfu`` / ``*.mbu`` gauges (``cost``)
- ``FLIGHTREC`` — bounded rings of recent spans, metric deltas and chaos
  fires, dumped to a JSON bundle on failure triggers (``flightrec``)
- ``TimeSeriesStore`` — background sampler turning the registry into
  bounded per-series rings + JSONL history (``timeseries``)
- ``GoodputTracker`` — wall-clock state accounting for supervised runs
  (``goodput``)
- ``SLObjective`` / ``SLOEvaluator`` — rolling-window objectives with
  multi-window burn rates, ``slo.burn_rate.*`` (``slo``)
- ``FleetScraper`` / ``FederatedRegistry`` — metric federation across a
  replica pool; ``TENANTS`` bounded tenant labels; ``ForecastEvaluator``
  time-to-breach extrapolation (``fleet``)
- ``StatusServer`` — ``/healthz`` ``/metrics`` ``/metrics.prom``
  ``/status`` (``server``)
- ``sample_device_memory`` / ``sample_state_bytes`` — per-device memory
  gauges (``device``)
- ``enabled`` / ``enable`` / ``disable`` — the process-wide flag; no
  per-step allocation while off (``core``)
"""

from . import tracing as trace
from .core import NOOP_SPAN, disable, enable, enabled
from .cost import COSTS, CostInfo, CostModel
from .device import sample_device_memory, sample_state_bytes
from .fleet import (TENANTS, FederatedRegistry, FleetScraper,
                    ForecastEvaluator, TenantLabels, parse_prometheus)
from .flightrec import FLIGHTREC, FlightRecorder
from .goodput import GoodputTracker
from .metrics import (DEFAULT_TIME_BUCKETS, METRICS, Histogram,
                      MetricsRegistry, StepTimer)
from .server import StatusServer
from .slo import SLObjective, SLOEvaluator
from .slo import default_serving_objectives, default_training_objectives
from .timeseries import TimeSeriesStore
from .tracing import TRACER, Tracer, profiler_trace, span

__all__ = [
    "COSTS", "CostInfo", "CostModel", "DEFAULT_TIME_BUCKETS", "FLIGHTREC",
    "FederatedRegistry", "FleetScraper", "FlightRecorder",
    "ForecastEvaluator", "GoodputTracker", "Histogram", "METRICS",
    "MetricsRegistry", "NOOP_SPAN", "SLOEvaluator", "SLObjective",
    "StatusServer", "StepTimer", "TENANTS", "TRACER", "TenantLabels",
    "TimeSeriesStore", "Tracer",
    "default_serving_objectives", "default_training_objectives",
    "disable", "enable", "enabled", "parse_prometheus", "profiler_trace",
    "sample_device_memory", "sample_state_bytes", "span", "trace",
]
