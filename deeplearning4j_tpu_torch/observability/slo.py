"""Service-level objectives with multi-window error-budget burn rates.

Port of ``deeplearning4j_tpu/observability/slo.py``.  An
:class:`SLObjective` declares what "good" means for one series over
rolling windows; an :class:`SLOEvaluator` rides the
:class:`~.timeseries.TimeSeriesStore` sampler and computes, per objective
and window, the burn rate: 1.0 is exactly on budget, N spends the budget
in 1/N of its period.

Kinds: ``upper`` (the series stays at or below ``objective``: TTFT p99,
inter-token p99, step time p99), ``lower`` (at or above: the goodput
floor), ``rate`` (Δ``series`` / Δ``denominator`` over the window against
the budgeted bad fraction ``objective``: errors and 429s).

A breach fires only when every window with data burns at or above
``burn_threshold`` and at least one window is full; it dumps a
flight-recorder bundle (objective, windows, burns, the series' tail) and
cools down.  Every evaluation publishes ``slo.burn_rate.<name>`` (the
worst full-window burn), which the router's control plane reads back.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

from . import core
from .flightrec import FLIGHTREC, FlightRecorder
from .metrics import METRICS, MetricsRegistry
from .timeseries import TimeSeriesStore

# How many trailing points of the offending series a breach bundle keeps.
BUNDLE_TAIL = 32


@dataclass(frozen=True)
class SLObjective:
    """One declarative rolling-window objective."""

    name: str                 # gauge suffix: slo.burn_rate.<name>
    kind: str                 # "upper" | "lower" | "rate"
    series: str               # sampled series (numerator counter for rate)
    objective: float          # threshold (or budgeted bad fraction for rate)
    denominator: str | None = None     # rate only: total-events counter
    budget: float = 0.05      # upper/lower: allowed bad-sample fraction
    windows: tuple[float, ...] = (30.0, 120.0)   # seconds, short → long
    burn_threshold: float = 1.0

    def __post_init__(self):
        if self.kind not in ("upper", "lower", "rate"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "rate" and not self.denominator:
            raise ValueError(f"rate objective {self.name!r} needs a denominator")
        if not self.windows:
            raise ValueError(f"objective {self.name!r} declares no windows")


@dataclass
class WindowBurn:
    """Burn for one (objective, window) pair at one evaluation instant."""

    window_s: float
    burn: float | None        # None: no data in the window yet
    full: bool                # store history covers the whole window
    samples: int


def default_serving_objectives(ttft_p99_s: float = 0.5,
                               inter_token_p99_s: float = 0.25,
                               error_rate: float = 0.05,
                               windows: tuple[float, ...] = (30.0, 120.0),
                               ) -> list[SLObjective]:
    """The serving trio: TTFT p99, inter-token p99, error+429 rate."""
    return [
        SLObjective("serving_ttft_p99", "upper", "serving.ttft.p99",
                    ttft_p99_s, windows=windows),
        SLObjective("serving_inter_token_p99", "upper",
                    "serving.decode_step.p99", inter_token_p99_s,
                    windows=windows),
        SLObjective("serving_error_rate", "rate", "serving.rejected",
                    error_rate, denominator="serving.requests",
                    windows=windows),
    ]


def default_training_objectives(step_p99_s: float = 5.0,
                                goodput_floor: float = 0.5,
                                windows: tuple[float, ...] = (60.0, 300.0),
                                ) -> list[SLObjective]:
    """The training pair: step-time p99 ceiling and goodput floor."""
    return [
        SLObjective("train_step_p99", "upper", "train_step.p99",
                    step_p99_s, windows=windows),
        SLObjective("train_goodput", "lower", "goodput.fraction",
                    goodput_floor, windows=windows),
    ]


class SLOEvaluator:
    """Evaluates objectives against a store's rings on every sample."""

    def __init__(self, objectives: list[SLObjective], store: TimeSeriesStore,
                 registry: MetricsRegistry = METRICS,
                 flightrec: FlightRecorder = FLIGHTREC,
                 breach_cooldown_s: float = 60.0,
                 attach: bool = True):
        self.objectives = list(objectives)
        self.store = store
        self.registry = registry
        self.flightrec = flightrec
        self.breach_cooldown_s = float(breach_cooldown_s)
        self.evaluations = 0
        self.breaches: list[str] = []          # bundle paths (or "" if inhibited)
        # First breach instant per objective (sample-clock time) — the
        # forecast tier's ground truth: a useful forecast published its
        # warning strictly before the time recorded here.
        self.breach_times: dict[str, float] = {}
        self.last: dict[str, list[WindowBurn]] = {}
        self._last_breach_t: dict[str, float] = {}
        if attach:
            store.add_evaluator(self.evaluate)

    # ------------------------------------------------------------ windows
    def _window_burn(self, obj: SLObjective, window_s: float,
                     now: float) -> WindowBurn:
        if obj.kind == "rate":
            num = self.store.window(obj.series, window_s, now)
            den = self.store.window(obj.denominator or "", window_s, now)
            full = self._covers(obj.denominator or "", window_s, now)
            if len(den) < 2:
                return WindowBurn(window_s, None, full, len(den))
            d_den = den[-1][1] - den[0][1]
            d_num = (num[-1][1] - num[0][1]) if len(num) >= 2 else 0.0
            if d_den <= 0:
                return WindowBurn(window_s, None, full, len(den))
            rate = max(0.0, d_num) / d_den
            return WindowBurn(window_s, rate / obj.objective, full, len(den))
        pts = self.store.window(obj.series, window_s, now)
        full = self._covers(obj.series, window_s, now)
        if not pts:
            return WindowBurn(window_s, None, full, 0)
        if obj.kind == "upper":
            bad = sum(1 for _, v in pts if v > obj.objective)
        else:
            bad = sum(1 for _, v in pts if v < obj.objective)
        burn = (bad / len(pts)) / obj.budget if obj.budget > 0 else float("inf")
        return WindowBurn(window_s, burn, full, len(pts))

    def _covers(self, series: str, window_s: float, now: float) -> bool:
        pts = self.store.series(series)
        return bool(pts) and pts[0][0] <= now - window_s

    # ---------------------------------------------------------- evaluation
    def evaluate(self, store: TimeSeriesStore | None = None,
                 now: float | None = None) -> dict[str, list[WindowBurn]]:
        """One pass over every objective.  Signature matches the store's
        evaluator hook ``fn(store, t)``."""
        if not core.enabled():
            return {}
        if now is None:
            now = time.time()
        self.evaluations += 1
        out: dict[str, list[WindowBurn]] = {}
        for obj in self.objectives:
            burns = [self._window_burn(obj, w, now) for w in obj.windows]
            out[obj.name] = burns
            computed = [b for b in burns if b.burn is not None]
            full = [b for b in computed if b.full]
            worst = max((b.burn for b in full), default=None)
            if worst is None and computed:
                worst = max(b.burn for b in computed)
            if worst is not None:
                self.registry.gauge(f"slo.burn_rate.{obj.name}", worst)
            breach = (bool(full)
                      and len(computed) == len(burns)
                      and all(b.burn >= obj.burn_threshold for b in computed))
            if breach:
                self._breach(obj, burns, now)
        self.last = out
        return out

    def _breach(self, obj: SLObjective, burns: list[WindowBurn],
                now: float) -> None:
        last = self._last_breach_t.get(obj.name)
        if last is not None and now - last < self.breach_cooldown_s:
            return
        self._last_breach_t[obj.name] = now
        self.breach_times.setdefault(obj.name, now)
        self.registry.increment("slo.breaches")
        tail = self.store.series(obj.series)[-BUNDLE_TAIL:]
        path = self.flightrec.dump("slo_breach", extra={
            "objective": obj.name,
            "kind": obj.kind,
            "series": obj.series,
            "threshold": obj.objective,
            "burn_threshold": obj.burn_threshold,
            "windows": [{
                "window_s": b.window_s, "burn": b.burn,
                "full": b.full, "samples": b.samples} for b in burns],
            "series_tail": [[t, v] for t, v in tail],
        })
        self.breaches.append(str(path) if path else "")

    # ------------------------------------------------------------- report
    def status(self) -> dict[str, Any]:
        return {
            "evaluations": self.evaluations,
            "breaches": len(self.breaches),
            "objectives": {
                name: [{"window_s": b.window_s, "burn": b.burn,
                        "full": b.full, "samples": b.samples}
                       for b in burns]
                for name, burns in self.last.items()
            },
        }

    def burn_rate(self, name: str) -> float | None:
        """Latest worst-window burn for one objective (None before data)."""
        burns = self.last.get(name)
        if not burns:
            return None
        vals = [b.burn for b in burns if b.burn is not None]
        return max(vals) if vals else None
