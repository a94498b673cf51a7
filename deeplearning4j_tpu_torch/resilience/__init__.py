"""Resilience: fault injection + self-healing supervision.

Port of ``deeplearning4j_tpu/resilience/``.

Three cooperating parts:

- :mod:`.faults` — a deterministic, seedable chaos layer: named injection
  sites across the training stack (worker death, slow worker, checkpoint
  corruption, data-pipeline failure, transient step failure, simulated
  preemption), armed via :func:`inject_faults` or ``DL4J_TPU_FAULTS``.
- :mod:`.supervisor` — :class:`TrainingSupervisor`: bounded retry with
  backoff + jitter, resume from the newest *valid* checkpoint, NaN/Inf
  divergence rollback, SIGTERM/SIGINT emergency checkpointing, elastic
  shrink and grow over a trainer factory.
- hardening in the layer underneath: ``parallel/checkpoint.py`` checksum
  verification and restore fallback.
"""

from .faults import (
    FAULTS,
    DataIteratorFault,
    DeviceLossError,
    DivergenceError,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    PreemptionSignal,
    TrainingPreempted,
    TransientStepFault,
    WorkerKilled,
    corrupt_file,
    inject_faults,
    parse_fault_env,
)
from .supervisor import RetryPolicy, SupervisorReport, TrainingSupervisor

__all__ = [
    "FAULTS", "DataIteratorFault", "DeviceLossError", "DivergenceError",
    "FaultInjector",
    "FaultSpec", "InjectedFault", "PreemptionSignal", "RetryPolicy",
    "SupervisorReport", "TrainingPreempted", "TrainingSupervisor",
    "TransientStepFault", "WorkerKilled", "corrupt_file", "inject_faults",
    "parse_fault_env",
]
