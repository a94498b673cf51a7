"""Self-healing training supervisor.

Port of ``deeplearning4j_tpu/resilience/supervisor.py``.  Wraps a
:class:`~..parallel.trainer.DataParallelTrainer` fit (and, via
:meth:`TrainingSupervisor.supervise`, any run-shaped callable) with the
recovery policy:

- **bounded retry** with exponential backoff + jitter
  (:class:`RetryPolicy`) — a transient step failure, a dying data
  pipeline, or a crashed attempt resumes from the newest *valid*
  checkpoint (params + transform state + RNG key + data cursor), so a
  retried run re-joins the uninterrupted trajectory bitwise;
- **NaN/Inf divergence guard**: the trainer detects a non-finite loss at
  the async resolution point and raises
  :class:`~.faults.DivergenceError`; the supervisor rolls back to the
  last checkpoint and (optionally) skips the offending batch window;
- **preemption handling**: SIGTERM/SIGINT set a flag the fit loop polls
  between steps; the trainer drains its pending ring, writes an
  emergency checkpoint, and returns — the supervisor then either resumes
  (injected preemption) or raises :class:`~.faults.TrainingPreempted` so
  the process can exit having lost nothing.

Elastic resize (a trainer factory rebuilding the mesh after a device loss
or re-admission) is multi-device work: :meth:`TrainingSupervisor._resize`
raises ``NotImplementedError`` naming ``ROADMAP.md`` A10.

Every recovery event is counted in the metrics registry
(``resilience.retries``, ``resilience.rollbacks``,
``resilience.preemptions``, ``resilience.emergency_checkpoints``,
``resilience.gave_up``) and summarized in :class:`SupervisorReport`.

This module imports nothing from ``parallel/``: the trainer and the
checkpoint manager arrive as arguments.
"""

from __future__ import annotations

import dataclasses
import random
import signal
import threading
import time
from typing import Any, Callable

from ..observability import FLIGHTREC, METRICS, trace
from ..observability import enabled as _obs_enabled
from ..observability.goodput import GoodputTracker
from .faults import FAULTS, DeviceLossError, DivergenceError, TrainingPreempted


def _devices_of(trainer) -> list:
    """The devices a trainer runs on (one, until the multi-device port)."""
    return [trainer.device]


def _loss_tail(by_step: dict, n: int = 32) -> dict:
    """The last ``n`` step-keyed losses (JSON-safe) for a flight bundle."""
    return {int(s): float(by_step[s]) for s in sorted(by_step)[-n:]}


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff + jitter.

    ``max_attempts`` bounds a *failure streak*: a successful attempt (or a
    divergence rollback, which has its own ``max_rollbacks`` budget)
    resets the streak.  ``retry_on`` is the exception tuple that counts
    as retryable — everything else propagates immediately.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 5.0
    jitter: float = 0.1
    retry_on: tuple = (Exception,)

    def backoff(self, attempt: int, rng: random.Random) -> float:
        base = min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_factor ** max(0, attempt - 1))
        return base * (1.0 + self.jitter * rng.random())


@dataclasses.dataclass
class SupervisorReport:
    """What happened across one supervised run (also mirrored to METRICS)."""

    attempts: int = 0              # fit attempts started
    retries: int = 0               # attempts that ended in a retryable failure
    rollbacks: int = 0             # divergence rollbacks
    preemptions: int = 0           # injected/simulated preemptions resumed
    emergency_checkpoints: int = 0
    skipped_steps: int = 0         # batch-window steps skipped after rollback
    resumed_from: list = dataclasses.field(default_factory=list)
    resizes: int = 0               # topology changes (shrink + grow)
    mesh_sizes: list = dataclasses.field(default_factory=list)  # after each resize
    # step -> loss for every step a successful attempt resolved; steps
    # whose attempt aborted mid-window are absent (their losses died with
    # the pending ring), so consumers must align by step, not position
    losses_by_step: dict = dataclasses.field(default_factory=dict)
    # GoodputTracker.report() of the run (None when observability is off):
    # wall-clock classified into productive/checkpoint/restore/rollback/
    # stall/drain, summing to wall-clock by construction
    goodput: dict | None = None


class TrainingSupervisor:
    """Retry / rollback / preemption supervisor around a trainer fit.

    ``checkpoint_manager`` is required for :meth:`fit` (resume is the
    whole recovery mechanism) and unused by :meth:`supervise`.
    ``install_signal_handlers`` hooks SIGTERM/SIGINT for
    emergency-checkpoint-then-exit; it is skipped automatically off the
    main thread (the ``signal`` module's constraint).
    """

    def __init__(self, checkpoint_manager=None, policy: RetryPolicy | None = None,
                 *, nan_guard: bool = True, skip_window_on_divergence: bool = True,
                 max_rollbacks: int = 3, install_signal_handlers: bool = True,
                 seed: int = 0):
        self.manager = checkpoint_manager
        self.policy = policy or RetryPolicy()
        self.nan_guard = nan_guard
        self.skip_window_on_divergence = skip_window_on_divergence
        self.max_rollbacks = max_rollbacks
        self.install_signal_handlers = install_signal_handlers
        self.report = SupervisorReport()
        self._rng = random.Random(seed)
        self._preempt_requested = False
        self._injected_preempt = False
        self._grow_requested = False
        self._lost_devices: list = []  # quarantined chips awaiting re-admission
        self.trainer = None  # the live trainer (rebuilt on every resize)
        self.goodput: GoodputTracker | None = None  # set per fit() run
        self._old_handlers: dict[int, Any] = {}

    # ------------------------------------------------------------- signals
    def _handle_signal(self, signum, frame) -> None:
        self._preempt_requested = True
        METRICS.increment("resilience.signals")

    def _install_signals(self) -> None:
        if (not self.install_signal_handlers
                or threading.current_thread() is not threading.main_thread()):
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._old_handlers[sig] = signal.signal(sig, self._handle_signal)

    def _restore_signals(self) -> None:
        for sig, old in self._old_handlers.items():
            signal.signal(sig, old)
        self._old_handlers.clear()

    def _should_stop(self, step: int) -> bool:
        """The fit loop's per-step preemption poll: real signals, the
        injected ``preempt`` fault site, and the ``mesh.grow`` re-admission
        signal all land here — each drains the run through the trainer's
        emergency-checkpoint path before the supervisor acts."""
        if self._preempt_requested:
            return True
        if FAULTS.check("preempt", step) is not None:
            self._injected_preempt = True
            return True
        if FAULTS.check("mesh.grow", step) is not None:
            # graceful half of elasticity: a quarantined worker re-registered.
            # Drain (the trainer writes the emergency checkpoint), then the
            # fit loop rebuilds the mesh LARGER and resumes from it.
            self._grow_requested = True
            return True
        return False

    # ------------------------------------------------------------- elastic
    def _resize(self, factory, old_devices, new_devices, step, direction):
        """Rebuild the trainer over ``new_devices`` — elastic resize, which
        needs a mesh over several devices (``ROADMAP.md`` A10)."""
        raise NotImplementedError(
            f"elastic {direction} from {len(old_devices)} to "
            f"{len(new_devices)} device(s) at step {step}: a mesh over "
            "several devices is not ported to deeplearning4j_tpu_torch yet "
            "(ROADMAP.md A10)")

    # ------------------------------------------------------------- generic
    def supervise(self, fn: Callable, *args, **kwargs):
        """Bounded-retry wrapper for run-shaped callables that own their
        own resume semantics (``Driver.run``, ``DistributedRunner.run``)."""
        attempt = 0
        while True:
            self.report.attempts += 1
            try:
                return fn(*args, **kwargs)
            except self.policy.retry_on:
                attempt += 1
                self.report.retries += 1
                METRICS.increment("resilience.retries")
                if attempt >= self.policy.max_attempts:
                    METRICS.increment("resilience.gave_up")
                    raise
                time.sleep(self.policy.backoff(attempt, self._rng))

    # ------------------------------------------------------------- fit
    def fit(self, trainer, params, data, *, epochs: int = 1,
            checkpoint_every: int = 1, key=None,
            **fit_kwargs) -> tuple[Any, list[float]]:
        """Supervised ``trainer.fit``: run to completion through faults.

        ``data`` must be re-iterable, or a zero-arg callable returning a
        fresh iterable per attempt (one-shot generators cannot be
        replayed after a mid-stream failure).  Returns the final state
        and the per-step losses keyed by step (each step's loss appears
        once even when a window was re-run after a rollback).

        ``trainer`` may also be a FACTORY ``callable(devices) -> trainer``
        (anything without a ``.fit`` attribute): ``factory(None)`` builds
        the trainer, and the supervisor would own elasticity — rebuilding
        over the survivors on :class:`DeviceLossError`, or larger on a
        ``mesh.grow`` signal.  On one device there are no survivors, and
        the resize raises ``NotImplementedError`` (``ROADMAP.md`` A10).
        Without a factory a device loss propagates.
        """
        if self.manager is None:
            raise ValueError("TrainingSupervisor.fit requires a checkpoint_manager")
        factory = None
        if callable(trainer) and not hasattr(trainer, "fit"):
            factory = trainer
            trainer = factory(None)
        self.trainer = trainer
        METRICS.gauge("elastic.mesh_size", len(_devices_of(trainer)))
        data_factory = data if callable(data) else (lambda: data)
        by_step: dict[int, float] = {}
        streak = 0
        rollbacks = 0
        extra_skip = 0
        self._preempt_requested = False
        self._grow_requested = False
        # goodput accounting: the supervisor owns the tracker, the trainer
        # marks restore/checkpoint/stall/drain, the exception arms below
        # mark rollback/restore.  None when
        # observability is off — the fit loop then does zero extra work.
        gp = fit_kwargs.pop("goodput", None)
        if gp is None and _obs_enabled():
            gp = GoodputTracker()
        self.goodput = gp
        self._install_signals()
        try:
            with trace.span("resilience.supervised_fit", epochs=epochs):
                while True:
                    self._injected_preempt = False
                    self.report.attempts += 1
                    resumed = self.manager.latest_valid_step()
                    if resumed is not None:
                        self.report.resumed_from.append(resumed)
                    template = trainer.init_state(params, key=key)
                    try:
                        state, losses = trainer.fit(
                            template, data_factory(), epochs=epochs,
                            checkpoint_manager=self.manager,
                            checkpoint_every=checkpoint_every, resume=True,
                            nan_guard=self.nan_guard,
                            should_stop=self._should_stop,
                            extra_skip=extra_skip, goodput=gp,
                            **fit_kwargs)
                    except DivergenceError as e:
                        if gp is not None:
                            gp.transition("rollback")
                        trainer.abort()
                        rollbacks += 1
                        self.report.rollbacks += 1
                        METRICS.increment("resilience.rollbacks")
                        # flight bundle BEFORE the rollback decision: the
                        # rings still hold the spans/chaos fires leading up
                        # to the NaN, and the loss tail is step-keyed
                        FLIGHTREC.dump("divergence", extra={
                            "step": int(e.step),
                            "value": repr(getattr(e, "value", None)),
                            "rollbacks": rollbacks,
                            "losses_tail": _loss_tail(by_step)})
                        if rollbacks > self.max_rollbacks:
                            METRICS.increment("resilience.gave_up")
                            raise
                        if self.skip_window_on_divergence:
                            # skip the batch window (target, e.step]: the
                            # restore covers steps <= target, extra_skip
                            # drops the batches that produced the NaN
                            target = self.manager.latest_valid_step() or 0
                            window = max(1, e.step - target)
                            extra_skip += window
                            self.report.skipped_steps += window
                        continue
                    except DeviceLossError as e:
                        # abrupt half of elasticity: chips died mid-step.
                        # The in-flight window is gone with them — drop it,
                        # rebuild from the survivors, reshard-resume.
                        if gp is not None:
                            gp.transition("restore")  # rebuild + reshard
                        trainer.abort()
                        METRICS.increment("resilience.device_losses")
                        if factory is None:
                            raise
                        old = _devices_of(trainer)
                        dead = set(id(d) for d in e.devices)
                        survivors = [d for d in old if id(d) not in dead]
                        if not survivors:
                            METRICS.increment("resilience.gave_up")
                            raise
                        self._lost_devices.extend(e.devices)
                        trainer = self._resize(factory, old, survivors,
                                               e.step, "shrink")
                        self.trainer = trainer
                        continue
                    except self.policy.retry_on as e:
                        if gp is not None:
                            gp.transition("rollback")  # incl. backoff sleep
                        trainer.abort()
                        streak += 1
                        self.report.retries += 1
                        METRICS.increment("resilience.retries")
                        FLIGHTREC.dump("supervisor_retry", extra={
                            "error": repr(e),
                            "streak": streak,
                            "losses_tail": _loss_tail(by_step)})
                        if streak >= self.policy.max_attempts:
                            METRICS.increment("resilience.gave_up")
                            raise
                        time.sleep(self.policy.backoff(streak, self._rng))
                        continue
                    streak = 0
                    for i, loss in enumerate(losses):
                        by_step[state.step - len(losses) + 1 + i] = loss
                    self.report.losses_by_step = dict(by_step)
                    if self._grow_requested:
                        self._grow_requested = False
                        self.report.emergency_checkpoints += 1
                        if factory is not None and self._lost_devices:
                            old = _devices_of(trainer)
                            have = {id(d) for d in old}
                            regained = [d for d in self._lost_devices
                                        if id(d) not in have]
                            self._lost_devices = []
                            if regained:
                                if gp is not None:
                                    gp.transition("restore")
                                trainer = self._resize(
                                    factory, old, old + regained,
                                    state.step, "grow")
                                self.trainer = trainer
                        continue  # resume from the drain checkpoint
                    if self._injected_preempt:
                        self.report.preemptions += 1
                        self.report.emergency_checkpoints += 1
                        METRICS.increment("resilience.preemptions")
                        continue  # resume from the emergency checkpoint
                    if self._preempt_requested:
                        METRICS.increment("resilience.preemptions")
                        exc = TrainingPreempted(state.step)
                        exc.state = state
                        raise exc
                    return state, [by_step[s] for s in sorted(by_step)]
        finally:
            if gp is not None:
                self.report.goodput = gp.finish()
            self._restore_signals()
