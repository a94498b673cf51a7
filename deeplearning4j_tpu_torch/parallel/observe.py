"""Compat shim: the observability names under their old import path.

Port of ``deeplearning4j_tpu/parallel/observe.py``; import from
``deeplearning4j_tpu_torch.observability``.
"""

from __future__ import annotations

from ..observability import (  # noqa: F401
    METRICS,
    MetricsRegistry,
    StatusServer,
    StepTimer,
    profiler_trace,
)

__all__ = ["METRICS", "MetricsRegistry", "StatusServer", "StepTimer",
           "profiler_trace"]
