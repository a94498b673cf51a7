"""Overload control: fair-share admission + graceful brownout.

Port of ``deeplearning4j_tpu/control/overload.py``.  Two admission-side
mechanisms, composed into one engine hook by :class:`OverloadGate`:

- :class:`TokenBucketAdmission` — per-tenant fair share.  Each bounded
  tenant label (the fold ``TENANTS`` stamped on the request) owns a token
  bucket refilled at ``rate_tokens_s``; a request charges its
  ``max_new_tokens``.  Over quota is a 429 (:class:`Throttled`) counted
  as ``tenant.<label>.throttled``.
- :class:`BrownoutController` — a burn-rate-driven ladder that trades
  quality for capacity before shedding load: level 1 turns speculative
  decoding off (same tokens), level 2 also clamps ``max_new`` (a prefix
  of the same tokens), level 3 also sheds background requests (429).
  Transitions are hysteresis-damped (enter above a threshold, exit below
  a lower one, a minimum dwell between moves), dumped to the flight
  recorder and published on ``control.brownout_level``.

The clocks are injectable, so a scripted signal sequence gives the same
decisions in both packages.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..observability import FLIGHTREC, METRICS, TENANTS
from ..serving.batcher import ServingRejected


class Throttled(ServingRejected):
    """Admission rejected by the overload gate (fair-share quota or
    brownout shedding) — back off and retry, HTTP 429."""

    status = 429


# ------------------------------------------------------------- fair share
@dataclass(frozen=True)
class BucketConfig:
    """Per-tenant token-bucket knobs (shared by every label)."""

    rate_tokens_s: float = 200.0   # sustained per-tenant refill
    burst_tokens: float = 400.0    # bucket capacity (idle credit cap)


class TokenBucketAdmission:
    """Per-tenant token buckets over BOUNDED labels.

    Keyed by ``request.tenant`` — already folded through
    ``TenantLabels`` at submit, so the bucket map inherits the same
    cardinality bound as the per-tenant metrics (unlabelled traffic
    shares the ``""`` bucket).  ``clock`` is injectable so tests refill
    deterministically.
    """

    def __init__(self, cfg: BucketConfig = BucketConfig(),
                 clock=time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        # label -> [tokens, last_refill_t]; guarded-by: self._lock
        self._buckets: dict[str, list[float]] = {}

    def charge(self, request) -> None:
        """Debit ``request.max_new_tokens`` from its tenant's bucket or
        raise :class:`Throttled` (the bucket is left untouched on
        rejection — a throttled tenant recovers at the refill rate, not
        slower for having asked)."""
        label = getattr(request, "tenant", "") or ""
        cost = float(request.max_new_tokens)
        now = self._clock()
        with self._lock:
            bucket = self._buckets.get(label)
            if bucket is None:
                bucket = [self.cfg.burst_tokens, now]
                self._buckets[label] = bucket
            tokens, last = bucket
            tokens = min(self.cfg.burst_tokens,
                         tokens + (now - last) * self.cfg.rate_tokens_s)
            bucket[1] = now
            if cost > tokens:
                bucket[0] = tokens
                METRICS.increment("control.throttled")
                TENANTS.account("throttled", label)
                raise Throttled(
                    f"tenant over fair-share quota "
                    f"({cost:.0f} tokens asked, {tokens:.0f} available) — "
                    "retry with backoff")
            bucket[0] = tokens - cost

    def available(self, tenant_label: str = "") -> float:
        """Current token balance for a label (refilled to now)."""
        now = self._clock()
        with self._lock:
            bucket = self._buckets.get(tenant_label)
            if bucket is None:
                return self.cfg.burst_tokens
            return min(self.cfg.burst_tokens,
                       bucket[0] + (now - bucket[1]) * self.cfg.rate_tokens_s)


# -------------------------------------------------------------- brownout
@dataclass(frozen=True)
class BrownoutConfig:
    """Ladder thresholds on the SLO burn rate, with hysteresis."""

    # enter level i+1 when burn >= enter_burn[i] (monotonic ladder)
    enter_burn: tuple[float, float, float] = (1.0, 2.0, 4.0)
    exit_fraction: float = 0.5     # drop a level when burn < enter * this
    dwell_s: float = 5.0           # min residence time between transitions
    clamp_max_new: int = 16        # the level-2 max_new cap


class BrownoutController:
    """Drives the quality ladder from the burn-rate signal.

    ``engine`` is duck-typed: it needs ``set_speculative(bool)`` and
    ``set_max_new_cap(int | None)`` — the :class:`InferenceEngine`
    brownout seams.  Level 3 shedding is enforced by the
    :class:`OverloadGate` consulting :attr:`shed_background`; the
    controller itself never touches the queue.  ``clock`` is injectable
    for deterministic dwell tests.
    """

    def __init__(self, engine=None, cfg: BrownoutConfig = BrownoutConfig(),
                 clock=time.monotonic):
        self.engine = engine
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        self._level = 0                    # guarded-by: self._lock
        self._since = clock()              # guarded-by: self._lock
        METRICS.gauge("control.brownout_level", 0.0)

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    @property
    def shed_background(self) -> bool:
        return self.level >= 3

    def _target_level(self, burn: float, current: int) -> int:
        """Hysteretic target: climb to the highest rung whose enter
        threshold ``burn`` clears; descend one rung only when burn is
        below ``exit_fraction`` of the CURRENT rung's enter threshold."""
        up = 0
        for i, thresh in enumerate(self.cfg.enter_burn):
            if burn >= thresh:
                up = i + 1
        if up > current:
            return up
        if current > 0 and \
                burn < self.cfg.enter_burn[current - 1] * self.cfg.exit_fraction:
            return current - 1   # one rung at a time — no cliff exits
        return current

    def update(self, burn: float | None) -> int:
        """Feed one burn-rate observation; returns the (possibly new)
        level.  ``None`` (no SLO data yet) holds the current level —
        absence of signal must never relax an active brownout."""
        if burn is None:
            return self.level
        with self._lock:
            current = self._level
            now = self._clock()
            if now - self._since < self.cfg.dwell_s:
                return current
            target = self._target_level(float(burn), current)
            if target == current:
                return current
            self._level = target
            self._since = now
        self._apply(current, target, float(burn))
        return target

    def _apply(self, old: int, new: int, burn: float) -> None:
        """Actuate + publish one transition (outside the level lock —
        the engine seams take their own locks)."""
        if self.engine is not None:
            self.engine.set_speculative(new < 1)
            self.engine.set_max_new_cap(
                self.cfg.clamp_max_new if new >= 2 else None)
        METRICS.increment("control.brownout_transitions")
        METRICS.gauge("control.brownout_level", float(new))
        FLIGHTREC.dump("control_brownout", extra={
            "old_level": old, "new_level": new, "burn": burn,
            "speculative": new < 1,
            "max_new_cap": self.cfg.clamp_max_new if new >= 2 else None,
            "shed_background": new >= 3})


# ------------------------------------------------------------- composition
class OverloadGate:
    """The composed admission hook: brownout shedding first (cheapest
    verdict), then fair share.  Install on an engine with
    :meth:`install` — serving stays ignorant of control (the hook seam
    points the other way)."""

    def __init__(self, bucket: TokenBucketAdmission | None = None,
                 brownout: BrownoutController | None = None):
        self.bucket = bucket
        self.brownout = brownout

    def __call__(self, request) -> None:
        if self.brownout is not None and self.brownout.shed_background \
                and getattr(request, "priority", 0) > 0:
            METRICS.increment("control.shed")
            TENANTS.account("throttled", getattr(request, "tenant", ""))
            raise Throttled(
                "background work shed under brownout — retry later")
        if self.bucket is not None:
            self.bucket.charge(request)

    def install(self, engine) -> "OverloadGate":
        engine.set_admission_hook(self)
        return self
