"""Kernel-tier observability: per-kernel timing histograms and the
auto-pick gauges.

Port of ``deeplearning4j_tpu/observability/kernels.py``: two publication
shims over the process-wide ``METRICS``, so the kernel tier
(``ops/cuda``) never imports histogram internals.

- ``record_kernel_time`` — one device-time observation per kernel call
  (``kernel.<kind>.<name>`` histogram) plus an optional bytes-moved gauge.
  Its caller is the tracer: every resolved ``kernel.<kind>.<phase>`` span
  (``tracing``; the training kernels' autograd forwards and backwards)
  lands here in device seconds, so ``/metrics`` shows their histograms.
- ``publish_autopick`` — every :class:`~..ops.cuda.registry.Pick` lands as
  ``bench.autopick.<kind>.*`` gauges (candidates considered, dropped,
  whether a non-incumbent was adopted) and a decisions counter.
"""

from __future__ import annotations

from .metrics import METRICS

# kernel calls run µs to ms: the default request-latency buckets would
# put everything in the first bin
KERNEL_TIME_BUCKETS = (
    1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1,
)


def record_kernel_time(kind: str, name: str, seconds: float,
                       bytes_moved: int | None = None) -> None:
    """One timing observation for a ``(kind, name)`` kernel dispatch:
    ``seconds`` of the device's time (CUDA events, as a device-timed span
    resolves them; a host clock would time the enqueue)."""
    metric = f"kernel.{kind}.{name}"
    METRICS.observe_time(metric, seconds, buckets=KERNEL_TIME_BUCKETS)
    if bytes_moved is not None:
        METRICS.gauge(f"{metric}.bytes_per_call", bytes_moved)
        if seconds > 0:
            METRICS.gauge(f"{metric}.gbps", bytes_moved / seconds / 1e9)


def publish_autopick(pick) -> None:
    """Export one auto-pick decision (a ``registry.Pick``) as gauges."""
    base = f"bench.autopick.{pick.kind}"
    METRICS.gauge(f"{base}.candidates", pick.considered)
    METRICS.gauge(f"{base}.dropped", len(pick.dropped))
    METRICS.gauge(f"{base}.adopted", 0.0 if pick.reason.startswith("default")
                  else 1.0)
    METRICS.increment("bench.autopick.decisions")
