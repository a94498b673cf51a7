"""Goodput accounting: where did the wall-clock go?

Port of ``deeplearning4j_tpu/observability/goodput.py``.  A
:class:`GoodputTracker` classifies a supervised run's wall-clock into
exhaustive, non-overlapping states:

- ``productive`` — the trainer is dispatching/resolving real steps
- ``checkpoint`` — saving (fence + serialize + fsync)
- ``restore`` — restoring state
- ``rollback`` — divergence rollback + retry backoff sleeps
- ``stall`` — the device was idle waiting on host data
- ``drain`` — cooperative stop/preemption drain (the emergency checkpoint
  window between the stop signal and the run's end)

The tracker is an interval state machine, not a span scraper: every
``transition()`` closes the current interval at the moment the next one
opens, so the per-state seconds are contiguous by construction and sum to
the wall-clock exactly.  ``goodput.fraction`` is the productive share.

Single-threaded by contract: the supervisor and the trainer it drives
mutate the tracker from the fit loop's thread, so there is no lock;
readers on other threads see only the published gauges.  Owned by
:class:`~..resilience.supervisor.TrainingSupervisor` (created only while
observability is enabled) and passed to ``DataParallelTrainer.fit(
goodput=...)``.
"""

from __future__ import annotations

import time
from typing import Any

from .metrics import METRICS, MetricsRegistry

# the exhaustive state set
STATES: tuple[str, ...] = (
    "productive", "checkpoint", "restore", "rollback", "stall", "drain")

# A data-fetch wait shorter than this is attributed to ``productive``:
# sub-millisecond queue pops are pipeline noise, not a stall, and
# materializing them would bloat the timeline without moving the fraction.
STALL_THRESHOLD_S = 0.005

# Coalesced interval entries kept for exact-sequence tests and bundles;
# the per-state seconds stay exact regardless of this cap.
TIMELINE_CAP = 1024


class _Phase:
    """``with tracker.phase("checkpoint"):`` — enter the state for the
    body, return to the interrupted state on exit."""

    __slots__ = ("tracker", "state", "prev")

    def __init__(self, tracker: "GoodputTracker", state: str):
        self.tracker = tracker
        self.state = state

    def __enter__(self):
        self.prev = self.tracker.state
        self.tracker.transition(self.state)
        return self

    def __exit__(self, *exc):
        self.tracker.transition(self.prev)
        return False


class GoodputTracker:
    """Classifies wall-clock into the :data:`STATES` intervals."""

    def __init__(self, registry: MetricsRegistry = METRICS,
                 stall_threshold_s: float = STALL_THRESHOLD_S,
                 timeline_cap: int = TIMELINE_CAP):
        self.registry = registry
        self.stall_threshold_s = float(stall_threshold_s)
        self.timeline_cap = int(timeline_cap)
        now = time.perf_counter()
        self.started_at = now
        self.state = "productive"
        self._t0 = now
        self.seconds: dict[str, float] = {s: 0.0 for s in STATES}
        # Coalesced (state, t0, dur) intervals, offsets relative to start.
        self.timeline: list[list[Any]] = []
        self.timeline_dropped = 0
        self.finished = False
        self._end: float | None = None

    # ------------------------------------------------------------ intervals
    def _close(self, t: float) -> None:
        dur = max(0.0, t - self._t0)
        self.seconds[self.state] += dur
        if dur > 0.0:
            rel = self._t0 - self.started_at
            if self.timeline and self.timeline[-1][0] == self.state:
                self.timeline[-1][2] += dur
            elif len(self.timeline) >= self.timeline_cap:
                self.timeline_dropped += 1
            else:
                self.timeline.append([self.state, rel, dur])

    def transition(self, state: str, t: float | None = None) -> None:
        """Close the current interval and open ``state`` at ``t`` (now by
        default).  ``t`` may not precede the current interval's start."""
        if self.finished:
            return
        if state not in self.seconds:
            raise ValueError(f"unknown goodput state {state!r}")
        if t is None:
            t = time.perf_counter()
        t = max(t, self._t0)
        self._close(t)
        self.state = state
        self._t0 = t

    def phase(self, state: str) -> _Phase:
        """Context manager: ``state`` for the body, previous state after."""
        return _Phase(self, state)

    def data_wait(self, t0: float, t1: float) -> None:
        """Attribute a measured host-data wait ``[t0, t1]`` (perf_counter
        seconds).  Waits under the threshold stay ``productive``; longer
        ones are carved out as a ``stall`` interval in place."""
        if self.finished or t1 - t0 < self.stall_threshold_s:
            return
        prev = self.state
        self.transition("stall", t0)
        self.transition(prev, t1)

    # ------------------------------------------------------------- results
    def wall_seconds(self, t: float | None = None) -> float:
        end = self._end if self._end is not None else (
            t if t is not None else time.perf_counter())
        return max(0.0, end - self.started_at)

    def fraction(self) -> float:
        """Productive share of wall-clock so far (1.0 for an empty run)."""
        now = time.perf_counter()
        wall = self.wall_seconds(now)
        prod = self.seconds["productive"]
        if not self.finished and self.state == "productive":
            prod += max(0.0, now - self._t0)
        return prod / wall if wall > 0 else 1.0

    def state_sequence(self) -> list[str]:
        """The coalesced state order — what the fixed-seed tests assert."""
        return [entry[0] for entry in self.timeline]

    def finish(self, t: float | None = None) -> dict[str, Any]:
        """Close the final interval, publish gauges, return the report.

        Idempotent: a second call returns the same report without moving
        the clock.
        """
        if not self.finished:
            if t is None:
                t = time.perf_counter()
            t = max(t, self._t0)
            self._close(t)
            self._end = t
            self.finished = True
            self.publish()
        return self.report()

    def publish(self) -> None:
        """Push ``goodput.fraction`` + per-state seconds gauges (also safe
        mid-run, where the open interval counts up to now)."""
        wall = self.wall_seconds()
        frac = self.fraction() if wall > 0 else 1.0
        self.registry.gauge("goodput.fraction", frac)
        self.registry.gauge("goodput.wall_seconds", wall)
        for s in STATES:
            self.registry.gauge(f"goodput.seconds.{s}", self.seconds[s])

    def report(self) -> dict[str, Any]:
        wall = self.wall_seconds()
        accounted = sum(self.seconds.values())
        return {
            "wall_seconds": wall,
            "accounted_seconds": accounted,
            "fraction": (self.seconds["productive"] / wall) if wall > 0 else 1.0,
            "seconds": dict(self.seconds),
            "timeline": [tuple(e) for e in self.timeline],
            "timeline_dropped": self.timeline_dropped,
            "states": self.state_sequence(),
        }
