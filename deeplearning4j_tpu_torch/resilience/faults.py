"""Deterministic, seedable fault injection — the chaos half of the
resilience subsystem.

Port of ``deeplearning4j_tpu/resilience/faults.py``.  The code under test
calls into ONE global :data:`FAULTS` injector at named sites; while the
injector is disarmed (the default) each site check is a single attribute
test, so hot loops pay nothing.

Sites wired in this package (grep for ``FAULTS.maybe_fire`` /
``FAULTS.check``):

=====================  =====================================================
site                   effect when armed
=====================  =====================================================
``train.step``         :class:`TransientStepFault` raised before dispatching
                       a train step (``DataParallelTrainer._dispatch``)
``data.next``          :class:`DataIteratorFault` raised from the host batch
                       stream (``DataParallelTrainer._host_stream``)
``checkpoint.write``   checkpoint payload corrupted *after* checksums are
                       recorded (``kind``: ``truncate`` | ``bitflip``) — the
                       published checkpoint fails ``verify()``
``preempt``            simulated preemption: the supervisor's ``should_stop``
                       poll returns True (emergency checkpoint + resume)
``mesh.shrink``        :class:`DeviceLossError` raised before dispatching a
                       train step (``DataParallelTrainer._dispatch``, via
                       ``FAULTS.check``); on one device nothing survives,
                       and the supervisor's resize is multi-device work
                       (``ROADMAP.md`` A10)
``mesh.grow``          the supervisor's ``should_stop`` poll drains the run
                       (emergency checkpoint) before a resize
``checkpoint.reshard`` :class:`TransientStepFault` raised inside a
                       cross-width ``CheckpointManager.restore`` before any
                       leaf is re-split
=====================  =====================================================

The serving, scaleout, router, capture, online, control and disagg sites
of the reference keep their exception mapping here and are wired when
their tiers are ported.

Arming:

- context manager (tests)::

      with inject_faults(FaultSpec("train.step", at_step=5),
                         FaultSpec("checkpoint.write", kind="bitflip",
                                   at_step=2), seed=42):
          ...

- environment (subprocess workers, chaos runs):
  ``DL4J_TPU_FAULTS="train.step:at=5;checkpoint.write:kind=bitflip,p=0.5"``
  with ``DL4J_TPU_FAULTS_SEED=<int>``.  Parsed lazily on the first site
  check, so worker processes spawned with the variable inherit the plan.

Determinism: probability draws use a per-site ``random.Random`` seeded from
``(seed, site)`` and a per-site call counter — the same plan + seed fires
at the same call indices regardless of wall clock or of other sites.
Every fire increments ``faults.injected.<site>`` in the metrics registry.
"""

from __future__ import annotations

import os
import random
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

from ..observability.metrics import METRICS

# --------------------------------------------------------------------------- errors

class InjectedFault(RuntimeError):
    """Base class for every exception the fault layer raises."""


class TransientStepFault(InjectedFault):
    """A single training step / job execution failed (retryable)."""


class DataIteratorFault(InjectedFault):
    """The input pipeline raised mid-stream (retryable)."""


class CaptureReplayFault(InjectedFault):
    """A capture-store replay failed mid-read (retryable next round)."""


class WorkerKilled(InjectedFault):
    """A scaleout worker died silently (no failure report — heartbeats
    just stop).  Raised inside the worker loop; never seen by the master."""


class PreemptionSignal(InjectedFault):
    """Simulated SIGTERM-style preemption notice."""


class DivergenceError(RuntimeError):
    """NaN/Inf loss detected at the async resolution point.

    ``step`` is the post-dispatch step number of the FIRST non-finite loss
    in the resolved window — the supervisor uses it to size the batch
    window to skip after rolling back.
    """

    def __init__(self, step: int, value: float):
        super().__init__(f"non-finite loss {value!r} at step {step}")
        self.step = step
        self.value = value


class DeviceLossError(RuntimeError):
    """One or more accelerator chips dropped out of the mesh mid-run.

    Injected by the ``mesh.shrink`` chaos site (on real hardware the
    analogue is a CUDA error naming a lost device).  Carries the
    step and the lost device objects so the supervisor can rebuild a mesh
    from the survivors and reshard onto it.
    """

    def __init__(self, step: int, devices):
        self.step = step
        self.devices = list(devices)
        names = [str(getattr(d, "id", d)) for d in self.devices]
        super().__init__(
            f"lost {len(self.devices)} device(s) [{', '.join(names)}] "
            f"at step {step}")


class TrainingPreempted(RuntimeError):
    """A real SIGTERM/SIGINT arrived: the emergency checkpoint was written
    and the supervisor is handing control back so the process can exit."""

    def __init__(self, step: int):
        super().__init__(f"preempted at step {step} (emergency checkpoint saved)")
        self.step = step


#: default exception per site for ``maybe_fire``
_SITE_EXC: dict[str, type[InjectedFault]] = {
    "train.step": TransientStepFault,
    "data.next": DataIteratorFault,
    "preempt": PreemptionSignal,
    "scaleout.worker": WorkerKilled,
    "scaleout.perform": TransientStepFault,
    "serving.request": TransientStepFault,
    "serving.decode": TransientStepFault,
    "router.route": TransientStepFault,
    "checkpoint.reshard": TransientStepFault,
    "capture.replay": CaptureReplayFault,
    "online.publish": TransientStepFault,
    "online.reload": TransientStepFault,
    "online.rollback": TransientStepFault,
    "control.autoscaler": TransientStepFault,
    # disagg tier: a killed prefill worker dies like a
    # scaleout worker (thread exits, twin respawns); a migrate fault is
    # transient — the scheduler requeues, refcounts must balance
    "disagg.prefill_worker": WorkerKilled,
    "disagg.migrate": TransientStepFault,
}


# --------------------------------------------------------------------------- specs

@dataclass
class FaultSpec:
    """One site's trigger: fire at an exact step/call index, or with a
    seeded per-call probability — never both silently (``at_step`` wins).

    ``max_fires`` bounds total fires (default 1: faults are *transient*
    by default, so a retried path does not re-fail forever); ``0`` means
    unbounded.  ``kind`` is a site-specific payload (checkpoint corruption
    flavor); ``delay_s`` is the injected sleep for slow-worker sites.
    """

    site: str
    probability: float = 0.0
    at_step: int | None = None
    kind: str = "bitflip"
    max_fires: int = 1
    delay_s: float = 0.05


@dataclass
class _SiteState:
    spec: FaultSpec
    calls: int = 0
    fires: int = 0
    rng: random.Random = field(default_factory=random.Random)


class FaultInjector:
    """The process-global chaos switchboard (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sites: dict[str, _SiteState] = {}
        self._armed = False
        self._env_checked = False

    # ------------------------------------------------------------- arming
    def arm(self, specs, seed: int = 0) -> None:
        with self._lock:
            self._sites = {}
            for spec in specs:
                st = _SiteState(spec=spec)
                st.rng.seed(f"{seed}:{spec.site}")
                self._sites[spec.site] = st
            self._armed = bool(self._sites)
            self._env_checked = True

    def disarm(self) -> None:
        with self._lock:
            self._sites = {}
            self._armed = False
            # re-allow env arming for the next explicit opt-in
            self._env_checked = False

    @property
    def armed(self) -> bool:
        return self._armed

    def _arm_from_env_locked(self) -> None:
        self._env_checked = True
        raw = os.environ.get("DL4J_TPU_FAULTS", "").strip()
        if not raw:
            return
        seed = int(os.environ.get("DL4J_TPU_FAULTS_SEED", "0"))
        specs = parse_fault_env(raw)
        for spec in specs:
            st = _SiteState(spec=spec)
            st.rng.seed(f"{seed}:{spec.site}")
            self._sites[spec.site] = st
        self._armed = bool(self._sites)

    # ------------------------------------------------------------- checks
    def check(self, site: str, step: int | None = None) -> FaultSpec | None:
        """Non-raising trigger test: returns the :class:`FaultSpec` when
        the site fires this call, else None.  The disarmed fast path is a
        single attribute test."""
        if not self._armed and self._env_checked:
            return None
        with self._lock:
            if not self._env_checked:
                self._arm_from_env_locked()
            st = self._sites.get(site)
            if st is None:
                return None
            st.calls += 1
            if st.spec.max_fires and st.fires >= st.spec.max_fires:
                return None
            if st.spec.at_step is not None:
                index = step if step is not None else st.calls
                fired = index == st.spec.at_step
            else:
                fired = st.rng.random() < st.spec.probability
            if not fired:
                return None
            st.fires += 1
        METRICS.increment(f"faults.injected.{site}")
        return st.spec

    def maybe_fire(self, site: str, step: int | None = None) -> None:
        """Raising trigger test: raises the site's mapped
        :class:`InjectedFault` subclass when the site fires."""
        spec = self.check(site, step)
        if spec is not None:
            exc = _SITE_EXC.get(site, InjectedFault)
            raise exc(f"injected fault at site {site!r}"
                      + (f" (step {step})" if step is not None else ""))

    def fire_count(self, site: str) -> int:
        with self._lock:
            st = self._sites.get(site)
            return st.fires if st is not None else 0

    def counts(self) -> dict[str, int]:
        with self._lock:
            return {s: st.fires for s, st in self._sites.items()}


def parse_fault_env(raw: str) -> list[FaultSpec]:
    """``"site:k=v,k=v;site2:k=v"`` -> specs.

    Keys: ``p``/``prob``/``probability``, ``at``/``at_step``, ``kind``,
    ``max``/``max_fires``, ``delay``/``delay_s``.  A site with no keys
    (``"preempt"``) fires once at probability 1.
    """
    specs = []
    for part in raw.split(";"):
        part = part.strip()
        if not part:
            continue
        site, _, kvs = part.partition(":")
        spec = FaultSpec(site=site.strip())
        if not kvs.strip():
            spec.probability = 1.0
        for kv in kvs.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k, v = k.strip(), v.strip()
            if k in ("p", "prob", "probability"):
                spec.probability = float(v)
            elif k in ("at", "at_step"):
                spec.at_step = int(v)
            elif k == "kind":
                spec.kind = v
            elif k in ("max", "max_fires"):
                spec.max_fires = int(v)
            elif k in ("delay", "delay_s"):
                spec.delay_s = float(v)
            else:
                raise ValueError(f"unknown fault spec key {k!r} in {part!r}")
        specs.append(spec)
    return specs


#: the process-global injector every instrumented site consults
FAULTS = FaultInjector()


@contextmanager
def inject_faults(*specs: FaultSpec, seed: int = 0):
    """Arm :data:`FAULTS` with ``specs`` for the duration of the block."""
    FAULTS.arm(specs, seed=seed)
    try:
        yield FAULTS
    finally:
        FAULTS.disarm()


def corrupt_file(path, kind: str = "bitflip") -> None:
    """Damage a file in place — the checkpoint-corruption payloads.

    ``truncate`` keeps the first half (torn write); ``bitflip`` flips one
    byte in the middle (silent medium corruption).  Both must be caught by
    the checksum ``verify()`` pass, never by a lucky parse error.
    """
    data = path.read_bytes()
    if kind == "truncate":
        path.write_bytes(data[: max(1, len(data) // 2)])
    elif kind == "bitflip":
        mid = len(data) // 2
        flipped = bytes([data[mid] ^ 0xFF])
        path.write_bytes(data[:mid] + flipped + data[mid + 1:])
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
