"""The SLO-driven autoscaler: a supervised control loop that fails safe.

Port of ``deeplearning4j_tpu/control/autoscaler.py``.  Signals in
(read-only): ``slo.burn_rate.*``, the live ``RequestQueue`` depth, and the
forecaster's time to breach.  Actions out, through the serving seams
only: grow via ``PrefixRouter.scale_up`` (the replica warms before ring
admission), shrink via ``scale_down`` (quarantine-path drain; on timeout
the replica is reactivated, never half-drained).  The
:class:`Autoscaler` is wired with four callables (``read_signals`` /
``scale_up`` / ``scale_down`` / ``pool_size``), which makes its decisions
testable against a scripted feed.

Decisions are damped three ways: a cooldown after any attempt (a failed
scale-up burns the window too), min/max pool bounds, and scale-in only
after ``down_consecutive`` quiet windows; at most one action a window.
The ``control.autoscaler`` fault site kills the loop for good: the pool
freezes at its size and ``control.autoscaler_alive`` drops to 0.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..observability import FLIGHTREC, METRICS, core, trace
from ..resilience.faults import FAULTS


@dataclass(frozen=True)
class AutoscalerConfig:
    """Control-loop knobs.  Defaults suit the smoke tools' time scale;
    production tunes ``interval_s``/``cooldown_s`` up together."""

    interval_s: float = 1.0        # evaluation window
    min_replicas: int = 1
    max_replicas: int = 4
    cooldown_s: float = 10.0       # after any attempted action
    burn_up: float = 1.0           # burn >= this -> scale up
    burn_down: float = 0.25        # burn <= this counts toward quiet
    queue_high: int = 32           # queue depth -> scale up
    queue_low: int = 2             # queue depth <= this counts toward quiet
    ttb_horizon_s: float = 120.0   # forecast breach inside this -> scale up
    down_consecutive: int = 3      # quiet windows before scale-in
    warm_timeout_s: float = 120.0  # passed through to scale_up actuators
    drain_timeout_s: float = 30.0  # passed through to scale_down actuators


@dataclass
class ControlSignals:
    """One window's worth of inputs to :meth:`Autoscaler.evaluate`."""

    burn: float | None = None        # worst full-window SLO burn rate
    queue_depth: int = 0             # live queued requests (swept)
    ttb_s: float | None = None       # forecast seconds to SLO breach


class Autoscaler:
    """Supervised scale controller over injected signal/actuator seams.

    ``read_signals()`` returns a :class:`ControlSignals`; ``scale_up()``
    and ``scale_down()`` perform one all-or-nothing resize (raising on
    failure); ``pool_size()`` returns current capacity.  ``clock`` is
    injectable so the hysteresis logic is testable without sleeping.
    Lifecycle follows the ``FleetScraper`` daemon idiom: ``start()`` is
    a no-op while alive, the loop swallows everything except the kill
    fault, ``stop()`` joins.
    """

    def __init__(self, read_signals, scale_up, scale_down, pool_size,
                 cfg: AutoscalerConfig = AutoscalerConfig(),
                 clock=time.monotonic):
        self.read_signals = read_signals
        self.scale_up = scale_up
        self.scale_down = scale_down
        self.pool_size = pool_size
        self.cfg = cfg
        self._clock = clock
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._dead = False             # killed by chaos — static capacity
        self._last_action_t: float | None = None
        self._quiet_windows = 0
        self._actions = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> bool:
        if not core.enabled():
            return False
        if self._dead:
            return False
        if self._thread is not None and self._thread.is_alive():
            return False
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dl4j-torch-autoscaler", daemon=True)
        self._thread.start()
        METRICS.gauge("control.autoscaler_alive", 1.0)
        return True

    def stop(self, timeout_s: float = 5.0) -> None:
        t = self._thread
        self._thread = None
        if t is None:
            return
        self._stop.set()
        t.join(timeout=timeout_s)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def dead(self) -> bool:
        return self._dead

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.step()
            except Exception:
                # the control loop must never take the process down —
                # a bad window is skipped, the next one reads fresh
                METRICS.increment("control.errors")
            if self._dead:
                break   # chaos kill: freeze at current (static) capacity

    # ------------------------------------------------------------ one window
    def step(self) -> str | None:
        """One control window: chaos check, read, decide, act (at most
        once).  Returns the action taken (``"up"``/``"down"``) or None."""
        if self._dead:
            return None
        if FAULTS.check("control.autoscaler") is not None:
            self._kill()
            return None
        sig = self.read_signals()
        decision = self.evaluate(sig, self._clock())
        if decision is not None:
            self._act(decision, sig)
        return decision

    def _kill(self) -> None:
        """Chaos took the controller: degrade to static capacity.  No
        actuator runs after this point — the pool keeps whatever size
        and routing state it had, which is a correct (if unelastic)
        configuration by construction."""
        self._dead = True
        METRICS.increment("control.autoscaler_killed")
        METRICS.gauge("control.autoscaler_alive", 0.0)
        FLIGHTREC.dump("control_autoscaler_killed", extra={
            "pool_size": self._safe_pool_size(),
            "actions_taken": self._actions})

    # ------------------------------------------------------------ decision
    def evaluate(self, sig: ControlSignals, now: float) -> str | None:
        """Pure-ish decision (mutates only hysteresis counters): returns
        ``"up"``, ``"down"`` or ``None`` for this window's signals."""
        cfg = self.cfg
        pressure = (
            (sig.burn is not None and sig.burn >= cfg.burn_up)
            or sig.queue_depth >= cfg.queue_high
            or (sig.ttb_s is not None and sig.ttb_s <= cfg.ttb_horizon_s))
        quiet = (
            (sig.burn is None or sig.burn <= cfg.burn_down)
            and sig.queue_depth <= cfg.queue_low
            and (sig.ttb_s is None or sig.ttb_s > cfg.ttb_horizon_s))
        # the quiet streak advances regardless of cooldown — a long calm
        # spell during cooldown still counts toward the scale-in vote
        self._quiet_windows = self._quiet_windows + 1 if quiet else 0
        if pressure:
            # any pressure window resets the scale-in vote even when the
            # cooldown blocks acting on it (hysteresis against flapping)
            self._quiet_windows = 0
        if self._last_action_t is not None \
                and now - self._last_action_t < cfg.cooldown_s:
            return None
        size = self._safe_pool_size()
        if pressure and size < cfg.max_replicas:
            return "up"
        if not pressure and self._quiet_windows >= cfg.down_consecutive \
                and size > cfg.min_replicas:
            return "down"
        return None

    # ------------------------------------------------------------ actuation
    def _act(self, direction: str, sig: ControlSignals) -> None:
        self._last_action_t = self._clock()   # a FAILED try burns it too
        self._quiet_windows = 0
        with trace.span("control.scale", direction=direction,
                        pool_size=self._safe_pool_size()):
            try:
                if direction == "up":
                    self.scale_up()
                else:
                    self.scale_down()
            except Exception as e:
                METRICS.increment("control.scale_errors")
                FLIGHTREC.dump("control_scale", extra={
                    "direction": direction, "ok": False, "error": str(e),
                    "burn": sig.burn, "queue_depth": sig.queue_depth,
                    "ttb_s": sig.ttb_s})
                return
        self._actions += 1
        if direction == "up":
            METRICS.increment("control.scale_up")
        else:
            METRICS.increment("control.scale_down")
        size = self._safe_pool_size()
        METRICS.gauge("control.pool_size", float(size))
        FLIGHTREC.dump("control_scale", extra={
            "direction": direction, "ok": True, "pool_size": size,
            "burn": sig.burn, "queue_depth": sig.queue_depth,
            "ttb_s": sig.ttb_s})

    def _safe_pool_size(self) -> int:
        try:
            return int(self.pool_size())
        except Exception:
            return 0


# ------------------------------------------------------------ wiring helpers
def router_signals(slo_evaluator, queue, objective: str,
                   forecast=None, forecast_objective: str | None = None):
    """Build a ``read_signals`` callable from the standard serving
    stack: an ``SLOEvaluator`` (worst full-window burn for
    ``objective``), a ``RequestQueue`` (live depth), and optionally a
    ``ForecastEvaluator`` (+ its objective name) for time-to-breach."""
    def read() -> ControlSignals:
        ttb = None
        if forecast is not None:
            ttb = forecast.ttb_seconds(forecast_objective or objective)
        return ControlSignals(
            burn=slo_evaluator.burn_rate(objective),
            queue_depth=queue.depth(),
            ttb_s=ttb)
    return read


def router_actuators(router, replica_factory,
                     cfg: AutoscalerConfig = AutoscalerConfig()):
    """Build ``(scale_up, scale_down, pool_size)`` over a
    :class:`~..serving.router.router.PrefixRouter`.  ``replica_factory``
    returns a fresh started-but-unadmitted ``Replica`` (an
    ``EngineReplica`` or a spawned ``ProcessReplica``); admission waits
    for its warmed flag inside ``router.scale_up``.  Scale-in drains the
    ring-order LAST replica (newest vnode owner) and closes it only
    after a clean detach."""
    def up() -> None:
        router.scale_up(replica_factory(),
                        warm_timeout_s=cfg.warm_timeout_s)

    def down() -> None:
        names = router.pool.names()
        victim = names[-1]
        rep = router.scale_down(victim,
                                drain_timeout_s=cfg.drain_timeout_s)
        rep.close()

    def size() -> int:
        return len(router.pool.names())

    return up, down, size


def wave_actuators(runner):
    """Build ``(scale_up, scale_down, pool_size)`` over an elastic
    training runner (``parallel.scaleout.DistributedRunner`` or its
    process runner): grow with ``register_worker``, shrink with the
    idle-only ``retire_worker`` (a no-eligible-worker window raises so
    the attempt is visible in ``control.scale_errors`` and retried
    after cooldown)."""
    def up() -> None:
        runner.register_worker()

    def down() -> None:
        if runner.retire_worker() is None:
            raise RuntimeError("no idle worker eligible to retire")

    def size() -> int:
        return len([w for w in runner.tracker.workers()
                    if runner.tracker.is_enabled(w)])

    return up, down, size
