"""Request admission: bounded queue, deadlines, coalescing.

Port of ``deeplearning4j_tpu/serving/batcher.py`` (generation requests
and the rows of batched score calls).
Backpressure is explicit: the queue is bounded and a full queue rejects
at submit time with :class:`QueueFull` (HTTP 429).  A request whose
deadline passed while queued completes with :class:`DeadlineExceeded`
and never occupies a decode slot.  When the engine is idle,
:meth:`RequestQueue.take` holds the first arrival up to
``max_batch_delay_ms`` for companions, so the first batch after an idle
period dispatches fuller.  Two priority tiers: interactive requests are
claimed ahead of background ones, with aging against starvation.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any

from ..observability.metrics import MetricsRegistry


class ServingRejected(RuntimeError):
    """Base of the load-shedding rejections; ``status`` is the HTTP code
    the server answers with."""

    status = 503


class QueueFull(ServingRejected):
    """The bounded request queue is at capacity — back off and retry."""

    status = 429


class DeadlineExceeded(ServingRejected):
    """The request's deadline passed while it was still queued."""

    status = 504


class PagePoolExhausted(ServingRejected):
    """The paged KV pool cannot cover a new sequence — admission
    backpressure (HTTP 429), not a crash: in-flight slots keep decoding."""

    status = 429


_REQ_IDS = itertools.count(1)

#: gauge of the live queued requests
DEPTH_GAUGE = "serving.queue.depth"

# priority tiers (GenerateRequest.priority / RequestQueue._tiers index)
INTERACTIVE = 0
BACKGROUND = 1


def _tier(request) -> int:
    """The queue tier of ``request``: a ``GenerateRequest`` with
    ``priority`` > 0 is background work; everything else, ``ScoreRequest``
    included (it has no ``priority``, as in the JAX package), is
    interactive."""
    if isinstance(request, GenerateRequest) and request.priority > 0:
        return BACKGROUND
    return INTERACTIVE


@dataclasses.dataclass
class GenerateRequest:
    """One autoregressive generation request in token-id space."""

    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0        # <= 0 -> greedy
    seed: int = 0                   # per-request torch.Generator seed
    eos_id: int | None = None       # evict the slot early on this token
    deadline_s: float | None = None  # absolute time.monotonic() deadline
    id: int = dataclasses.field(default_factory=lambda: next(_REQ_IDS))
    submitted_s: float = 0.0        # stamped by RequestQueue.submit
    tenant: str = ""                # opaque caller identity (carried; the
    #                                 per-tenant accounting comes with the
    #                                 observability registries)
    priority: int = 0               # INTERACTIVE (0) or BACKGROUND (1)


@dataclasses.dataclass
class ScoreRequest:
    """One row of a batched forward/score call (``BatchScorer``)."""

    x: Any
    deadline_s: float | None = None
    id: int = dataclasses.field(default_factory=lambda: next(_REQ_IDS))
    submitted_s: float = 0.0


@dataclasses.dataclass
class Completion:
    """Terminal result of a generation request.

    ``generation``/``loaded_step`` stamp the weight generation EVERY token
    of this completion was decoded under: the engine defers hot swaps to
    fences with no request in flight, so one response never mixes
    generations."""

    tokens: list[int]
    finish_reason: str              # "eos" | "length"
    latency_s: float = 0.0
    ttft_s: float | None = None     # fence-granular time to first token
    generation: int = 0             # weight generation (one per swap)
    loaded_step: int | None = None  # checkpoint step of that generation


class PendingResult:
    """Caller-facing handle: ``result()`` blocks until the engine
    completes (or fails) the request.  Completion is single-shot: the
    first of ``_complete``/``_fail`` wins, later ones are no-ops."""

    def __init__(self, request):
        self.request = request
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._value: Any = None                  # guarded-by: self._lock
        self._exc: BaseException | None = None   # guarded-by: self._lock

    def _complete(self, value) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            self._value = value
            self._done.set()
        return True

    def _fail(self, exc: BaseException) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            self._exc = exc
            self._done.set()
        return True

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.id} not completed within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._value


class RequestQueue:
    """Bounded two-tier FIFO between submitters and the engine loop.

    Tier 0 (INTERACTIVE) is claimed ahead of tier 1 (BACKGROUND); a
    background request older than ``aging_s`` is served ahead of newer
    interactive ones and cannot be preempted.  Deadline expiry removes a
    request the moment any queue operation observes it dead, so
    ``serving.queue.depth`` counts live work only."""

    def __init__(self, max_depth: int = 64, max_batch_delay_ms: float = 2.0,
                 aging_s: float = 2.0, *,
                 metrics: MetricsRegistry | None = None):
        self.max_depth = max_depth
        self.max_batch_delay_ms = max_batch_delay_ms
        self.aging_s = aging_s
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._cv = threading.Condition()
        self._tiers: list[deque[PendingResult]] = [deque(), deque()]
        self._woken = False              # guarded-by: self._cv

    def _total_locked(self) -> int:
        return len(self._tiers[INTERACTIVE]) + len(self._tiers[BACKGROUND])

    def _expire_locked(self, now: float) -> None:
        """Fail + remove every expired request in either tier."""
        swept = False
        for tier in self._tiers:
            live = [p for p in tier
                    if p.request.deadline_s is None
                    or now <= p.request.deadline_s]
            if len(live) == len(tier):
                continue
            for p in tier:
                dl = p.request.deadline_s
                if dl is not None and now > dl:
                    if p._fail(DeadlineExceeded(
                            f"request {p.request.id} expired after "
                            f"{now - p.request.submitted_s:.3f}s in queue")):
                        self.metrics.increment("serving.deadline_dropped")
            tier.clear()
            tier.extend(live)
            swept = True
        if swept:
            self.metrics.gauge(DEPTH_GAUGE, self._total_locked())

    def _pop_locked(self, now: float) -> PendingResult:
        """Next request: an aged background head, then interactive, then
        background."""
        bg = self._tiers[BACKGROUND]
        if bg and now - bg[0].request.submitted_s >= self.aging_s:
            return bg.popleft()
        inter = self._tiers[INTERACTIVE]
        if inter:
            return inter.popleft()
        return bg.popleft()

    def submit(self, request) -> PendingResult:
        """Enqueue or reject — never blocks the submitter."""
        with self._cv:
            now = time.monotonic()
            self._expire_locked(now)
            if self._total_locked() >= self.max_depth:
                self.metrics.increment("serving.rejected")
                raise QueueFull(
                    f"request queue full ({self.max_depth} deep) — retry "
                    "with backoff")
            request.submitted_s = now
            pending = PendingResult(request)
            self._tiers[_tier(request)].append(pending)
            self.metrics.gauge(DEPTH_GAUGE, self._total_locked())
            self._cv.notify()
        return pending

    def take(self, max_n: int, block_s: float = 0.0) -> list[PendingResult]:
        """Up to ``max_n`` admissible requests.  ``block_s > 0`` is the
        idle path: wait up to ``block_s`` for a first arrival, then hold
        it up to ``max_batch_delay_ms`` for companions.  ``block_s == 0``
        returns whatever is queued right now."""
        if max_n <= 0:
            return []
        out: list[PendingResult] = []
        with self._cv:
            if not self._total_locked() and block_s > 0:
                end = time.monotonic() + block_s
                while not self._total_locked() and not self._woken:
                    left = end - time.monotonic()
                    if left <= 0 or not self._cv.wait(left):
                        break
            self._woken = False
            if self._total_locked() and block_s > 0 \
                    and self._total_locked() < max_n \
                    and self.max_batch_delay_ms > 0:
                end = time.monotonic() + self.max_batch_delay_ms / 1000.0
                while self._total_locked() < max_n:
                    left = end - time.monotonic()
                    if left <= 0 or not self._cv.wait(left):
                        break
            now = time.monotonic()
            self._expire_locked(now)
            while self._total_locked() and len(out) < max_n:
                p = self._pop_locked(now)
                self.metrics.observe_time("serving.queue_wait",
                                          now - p.request.submitted_s)
                out.append(p)
            self.metrics.gauge(DEPTH_GAUGE, self._total_locked())
        return out

    def claim(self, p: PendingResult) -> bool:
        """Atomic expiry-vs-admission arbiter, called by the engine as it
        takes a slot: the request either expires here or is admitted.  A
        background request an interactive arrival now waits behind is
        pushed back to the head of its tier and the claim returns False
        (skip, not fail)."""
        with self._cv:
            if p.done():
                return False
            dl = p.request.deadline_s
            now = time.monotonic()
            if dl is not None and now > dl:
                if p._fail(DeadlineExceeded(
                        f"request {p.request.id} expired after "
                        f"{now - p.request.submitted_s:.3f}s before "
                        f"admission")):
                    self.metrics.increment("serving.deadline_dropped")
                return False
            if (_tier(p.request) == BACKGROUND
                    and self._tiers[INTERACTIVE]
                    and now - p.request.submitted_s < self.aging_s):
                self._tiers[BACKGROUND].appendleft(p)
                self.metrics.increment("serving.preempted")
                self.metrics.gauge(DEPTH_GAUGE, self._total_locked())
                self._cv.notify()
                return False
            return True

    def wake(self) -> None:
        """Kick any idle ``take`` out of its wait immediately."""
        with self._cv:
            self._woken = True
            self._cv.notify_all()

    def depth(self) -> int:
        """Live queued requests (expired ones swept first)."""
        with self._cv:
            self._expire_locked(time.monotonic())
            return self._total_locked()

    def drain(self) -> list[PendingResult]:
        """Remove and return everything queued (engine shutdown path)."""
        with self._cv:
            out = list(self._tiers[INTERACTIVE]) \
                + list(self._tiers[BACKGROUND])
            for tier in self._tiers:
                tier.clear()
            self.metrics.gauge(DEPTH_GAUGE, 0)
        return out
