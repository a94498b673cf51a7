"""Fleet observability: metric federation, tenant labels, forecasting.

Port of ``deeplearning4j_tpu/observability/fleet.py``.

- :func:`parse_prometheus` / :class:`FederatedRegistry` — the inverse of
  ``MetricsRegistry.to_prometheus``, line-tolerant (a torn scrape body
  yields the lines that arrived), stored keyed ``(series, replica)``.
- :class:`FleetScraper` — a daemon that pulls every pool member's
  ``/metrics.prom`` (quarantined replicas skipped, dead scrapes counted in
  ``fleet.scrape_errors`` and marked stale) and publishes fleet rollups
  (``fleet.tokens_per_sec``, ``fleet.kv_pages_in_use``,
  ``fleet.queue_depth``, ``fleet.tokens_total``) and per-replica spreads
  into the local registry.  The pool is duck-typed (``names()`` /
  ``is_active()`` / ``replica()``); staleness is judged by the local
  receive time only.  An empty body is an in-process replica sharing the
  local registry, folded in once.
- :class:`TenantLabels` — bounded tenant labels: the first
  ``max_tenants`` distinct ids are tracked exactly, later ones fold into
  ``__other__`` (``fleet.tenant_overflow``), by arrival order only.  The
  per-tenant counters (``tenant.<label>.*``) are minted here and only
  here.
- :class:`ForecastEvaluator` — least-squares extrapolation of each
  objective's series to a time to breach
  (``forecast.time_to_breach.<objective>``), with a ``forecast_breach``
  bundle when it falls under the horizon.

Disabled is free: every entry point returns before allocating while
``core.enabled()`` is false.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterable

from . import core
from .flightrec import FLIGHTREC, FlightRecorder
from .metrics import METRICS, MetricsRegistry, _prom_name
from .slo import BUNDLE_TAIL, SLObjective
from .timeseries import TimeSeriesStore

# The fold bucket every tenant beyond the tracked top-K lands in.
OTHER_TENANT = "__other__"

# Default cap on exactly-tracked tenant labels (top-K by arrival order).
DEFAULT_MAX_TENANTS = 32

# Rollups the scraper publishes: (fleet gauge, source series in registry
# dotted form, source kind).  Counter sources keep stale replicas' last
# known value in the sum (tokens already generated stay generated);
# gauge sources drop stale replicas (a dead replica has no queue depth).
ROLLUPS: tuple[tuple[str, str, str], ...] = (
    ("fleet.tokens_per_sec", "serving.tokens_per_sec", "gauge"),
    ("fleet.kv_pages_in_use", "serving.kv_pages_in_use", "gauge"),
    ("fleet.queue_depth", "serving.queue.depth", "gauge"),
    ("fleet.tokens_total", "serving.tokens", "counter"),
)


# --------------------------------------------------------------- text format
def _parse_value(s: str) -> float:
    # to_prometheus renders NaN / +Inf / repr(float); float() reads all
    # three back (and "-Inf" for symmetry with hand-written bodies).
    return float(s)


def _strip_suffix(name: str, suffix: str) -> str:
    return name[: -len(suffix)] if name.endswith(suffix) else name


def parse_prometheus(text: str) -> dict[str, Any]:
    """Parse Prometheus text exposition (0.0.4) back into values.

    The inverse of ``MetricsRegistry.to_prometheus``: returns
    ``{"counters": {...}, "gauges": {...}, "histograms": {...}}`` keyed
    by prometheus-sanitized names with the convention suffixes stripped
    (``_total`` off counters, ``_seconds`` off histograms) so keys line
    up with ``_prom_name(dotted_name)``.  Histogram entries carry
    ``{"buckets": [(le, cumulative), ...], "sum": float, "count": float}``.

    Torn bodies are tolerated line-by-line: an unparseable line (the
    replica died mid-render, the read was truncated) is skipped and the
    lines that did arrive are returned — a scraper must degrade, never
    raise.
    """
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    hists: dict[str, dict[str, Any]] = {}
    types: dict[str, str] = {}

    def _hist(base: str) -> dict[str, Any]:
        key = _strip_suffix(base, "_seconds")
        return hists.setdefault(key, {"buckets": [], "sum": None,
                                      "count": None})

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) == 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        try:
            if "{" in line:
                name, rest = line.split("{", 1)
                labels, sep, val_s = rest.partition("}")
                val_s = val_s.strip()
                if not sep or not val_s:
                    continue  # torn mid-labels or missing value
                value = _parse_value(val_s)
                if (name.endswith("_bucket") and labels.startswith('le="')
                        and labels.endswith('"')):
                    le = _parse_value(labels[4:-1])
                    _hist(name[: -len("_bucket")])["buckets"].append(
                        (le, value))
                continue  # other labeled series: nothing we render
            name, _, val_s = line.partition(" ")
            val_s = val_s.strip()
            if not name or not val_s:
                continue
            value = _parse_value(val_s)
        except ValueError:
            continue  # torn line — keep what we have
        kind = types.get(name)
        if kind == "counter":
            counters[_strip_suffix(name, "_total")] = value
        elif kind == "gauge":
            gauges[name] = value
        elif name.endswith("_sum") and types.get(name[:-4]) == "histogram":
            _hist(name[:-4])["sum"] = value
        elif name.endswith("_count") and types.get(name[:-6]) == "histogram":
            _hist(name[:-6])["count"] = value
        else:
            # TYPE header lost to the tear: a bare sample is still a
            # value — classify by convention suffix, default to gauge.
            if name.endswith("_total"):
                counters[_strip_suffix(name, "_total")] = value
            else:
                gauges[name] = value
    return {"counters": counters, "gauges": gauges, "histograms": hists}


# ---------------------------------------------------------------- federation
class FederatedRegistry:
    """Scraped metric values keyed ``(series, replica)``.

    Series names are accepted in registry dotted form or prometheus form
    (lookups normalize through ``_prom_name`` + suffix strip).  Replicas
    are marked stale when a scrape fails or the replica is quarantined;
    stale data is kept (counters remain true history) but flagged, and
    staleness is judged by *local* receive time only — replica clocks
    never enter the picture, so skew cannot fake liveness either way.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[str, dict[str, Any]] = {}
        self._scraped_t: dict[str, float] = {}   # local receive time
        self._stale: set[str] = set()

    def update(self, replica: str, parsed: dict[str, Any],
               t: float | None = None) -> None:
        with self._lock:
            self._data[replica] = parsed
            self._scraped_t[replica] = time.time() if t is None else t
            self._stale.discard(replica)

    def mark_stale(self, replica: str) -> None:
        with self._lock:
            self._stale.add(replica)

    def forget(self, replica: str) -> None:
        with self._lock:
            self._data.pop(replica, None)
            self._scraped_t.pop(replica, None)
            self._stale.discard(replica)

    # -------------------------------------------------------------- reading
    def replicas(self) -> list[str]:
        with self._lock:
            return sorted(self._data)

    def stale(self, replica: str) -> bool:
        with self._lock:
            return replica in self._stale

    def stale_replicas(self) -> list[str]:
        with self._lock:
            return sorted(self._stale)

    def age_s(self, replica: str, now: float | None = None) -> float | None:
        """Seconds since the last good scrape (local clock)."""
        with self._lock:
            t = self._scraped_t.get(replica)
        if t is None:
            return None
        return (time.time() if now is None else now) - t

    def value(self, series: str, replica: str) -> float | None:
        """One replica's latest value for a counter or gauge series."""
        key = _strip_suffix(_strip_suffix(_prom_name(series), "_total"),
                            "_seconds")
        with self._lock:
            parsed = self._data.get(replica)
            if parsed is None:
                return None
            v = parsed["counters"].get(key)
            if v is None:
                v = parsed["gauges"].get(_prom_name(series))
            return v

    def values(self, series: str,
               include_stale: bool = True) -> dict[str, float]:
        """``{replica: value}`` for every replica carrying the series."""
        out: dict[str, float] = {}
        with self._lock:
            replicas = list(self._data)
            stale = set(self._stale)
        for r in replicas:
            if not include_stale and r in stale:
                continue
            v = self.value(series, r)
            if v is not None:
                out[r] = v
        return out

    def snapshot(self) -> dict[str, Any]:
        """Full federated view for tools: per-replica parsed data plus
        staleness and scrape-age bookkeeping."""
        with self._lock:
            return {
                "replicas": {r: {"counters": dict(p["counters"]),
                                 "gauges": dict(p["gauges"]),
                                 "stale": r in self._stale,
                                 "scraped_t": self._scraped_t.get(r)}
                             for r, p in self._data.items()},
                "stale": sorted(self._stale),
            }


# ------------------------------------------------------------------ scraping
class FleetScraper:
    """Periodically federates every pool member's ``/metrics.prom``.

    ``pool`` is duck-typed: it needs ``names()``, ``is_active(name)``
    and ``replica(name)`` where the replica answers
    ``metrics_prom(timeout_s) -> str`` — exactly the
    ``ReplicaPool``/``Replica`` surface, without importing it.  The
    scrape loop runs on its own daemon thread, never the serve thread;
    a replica that dies mid-scrape costs one bounded timeout, one
    ``fleet.scrape_errors`` increment, and a stale mark — the other
    replicas' rollups are unaffected.
    """

    def __init__(self, pool, registry: MetricsRegistry = METRICS,
                 fed: FederatedRegistry | None = None,
                 interval_s: float = 1.0, timeout_s: float = 2.0):
        self.pool = pool
        self.registry = registry
        self.fed = fed if fed is not None else FederatedRegistry()
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> bool:
        if not core.enabled():
            return False
        if self._thread is not None and self._thread.is_alive():
            return False
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dl4j-torch-fleet-scraper", daemon=True)
        self._thread.start()
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

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:
                pass  # the scraper must never take the process down

    # -------------------------------------------------------------- scraping
    def scrape_once(self) -> int:
        """One federation pass.  Returns the number of replicas whose
        exposition text was scraped and parsed (0 while disabled — and
        no work was done)."""
        if not core.enabled():
            return 0
        t0 = time.perf_counter()
        scraped = 0
        for name in self.pool.names():
            if not self.pool.is_active(name):
                self.fed.mark_stale(name)   # quarantined: skip, don't probe
                continue
            try:
                body = self.pool.replica(name).metrics_prom(self.timeout_s)
            except Exception:
                self.registry.increment("fleet.scrape_errors")
                self.fed.mark_stale(name)
                continue
            if not body:
                continue  # in-process replica: shares the local registry
            self.fed.update(name, parse_prometheus(body))
            scraped += 1
        self.registry.increment("fleet.scrapes")
        self._publish()
        self.registry.observe_time("fleet.scrape", time.perf_counter() - t0)
        return scraped

    def _publish(self) -> None:
        """Fold the federated view into the local registry as rollups."""
        snap = self.registry.snapshot()
        fed = self.fed
        for fleet_name, series, kind in ROLLUPS:
            vals = fed.values(series, include_stale=(kind == "counter"))
            local = (snap["counters"].get(series) if kind == "counter"
                     else snap["gauges"].get(series))
            if local is not None:
                vals["_local"] = float(local)
            if not vals:
                continue
            ordered = sorted(vals.values())
            self.registry.gauge(fleet_name, sum(ordered))
            self.registry.gauge(f"fleet.spread.{series}.min", ordered[0])
            self.registry.gauge(f"fleet.spread.{series}.med",
                                ordered[len(ordered) // 2])
            self.registry.gauge(f"fleet.spread.{series}.max", ordered[-1])
        stale = fed.stale_replicas()
        self.registry.gauge("fleet.replicas", len(fed.replicas()))
        self.registry.gauge("fleet.stale_replicas", len(stale))


# ------------------------------------------------------------- tenant labels
class TenantLabels:
    """Bounded-cardinality tenant labels + per-tenant accounting.

    The first ``max_tenants`` distinct tenant ids are tracked exactly;
    every later id folds into ``__other__`` and bumps
    ``fleet.tenant_overflow``.  Folding is deterministic: whether a
    tenant is exact depends only on its arrival order, never on timing.

    This class is the only path from request-derived strings to metric
    names: call sites pass the raw tenant to :meth:`label` once at
    admission and account through :meth:`account`.
    """

    def __init__(self, registry: MetricsRegistry = METRICS,
                 max_tenants: int = DEFAULT_MAX_TENANTS):
        self.registry = registry
        self.max_tenants = int(max_tenants)
        self._lock = threading.Lock()
        self._tracked: set[str] = set()

    def label(self, tenant: str) -> str:
        """Fold a raw tenant id to its bounded metric label ("" while
        observability is off — the no-tenant fast path stays free)."""
        if not tenant or not core.enabled():
            return ""
        if tenant == OTHER_TENANT:
            return OTHER_TENANT
        with self._lock:
            if tenant in self._tracked:
                return tenant
            if len(self._tracked) < self.max_tenants:
                self._tracked.add(tenant)
                return tenant
        self.registry.increment("fleet.tenant_overflow")
        return OTHER_TENANT

    def account(self, field: str, tenant: str, by: float = 1.0) -> None:
        """Add ``by`` to ``tenant.<label>.<field>`` (no-op for empty
        tenant or while observability is off)."""
        if not tenant or not core.enabled():
            return
        label = self.label(tenant)
        if not label:
            return
        self.registry.increment(f"tenant.{label}.{field}", by)

    def tracked(self) -> list[str]:
        with self._lock:
            return sorted(self._tracked)

    def reset(self) -> None:
        with self._lock:
            self._tracked.clear()


TENANTS = TenantLabels()


# --------------------------------------------------------------- forecasting
class ForecastEvaluator:
    """Extrapolates SLO objective series to a time-to-breach forecast.

    Rides the same ``TimeSeriesStore`` evaluator hook as
    :class:`~.slo.SLOEvaluator` and, per objective, fits a least-squares
    line (:meth:`TimeSeriesStore.trend`) over the trailing ``window_s``
    of the objective's series, then extrapolates to the threshold:

    - ``upper``: rising toward the objective → seconds until the line
      crosses it; flat, receding, or noisy (R² < ``min_r2``) → ``+inf``;
      already at/over → ``0``.
    - ``lower``: mirrored (falling toward the floor).
    - ``rate``: the published ``slo.burn_rate.<name>`` series is
      extrapolated against ``burn_threshold`` as an upper bound (the
      raw counters are cumulative and always rise; the burn rate is the
      stationary signal).

    Every pass publishes ``forecast.time_to_breach.<objective>``; a
    forecast under ``horizon_s`` dumps ONE ``forecast_breach`` flight
    bundle per cooldown — the leading indicator an autoscaler or an
    operator acts on before the SLO evaluator records the real breach.

    The model is a straight line: good for ramps (queue buildup, KV
    leak, load growth), blind to cycles and steps — which is why the
    horizon should be a few windows, not hours.
    """

    def __init__(self, objectives: Iterable[SLObjective],
                 store: TimeSeriesStore,
                 registry: MetricsRegistry = METRICS,
                 flightrec: FlightRecorder = FLIGHTREC,
                 horizon_s: float = 120.0, window_s: float = 60.0,
                 min_r2: float = 0.5, min_samples: int = 4,
                 breach_cooldown_s: float = 60.0, attach: bool = True):
        self.objectives = list(objectives)
        self.store = store
        self.registry = registry
        self.flightrec = flightrec
        self.horizon_s = float(horizon_s)
        self.window_s = float(window_s)
        self.min_r2 = float(min_r2)
        self.min_samples = int(min_samples)
        self.breach_cooldown_s = float(breach_cooldown_s)
        self.evaluations = 0
        self.warnings: list[str] = []          # bundle paths ("" if inhibited)
        self.last: dict[str, float] = {}
        self._last_warn_t: dict[str, float] = {}
        if attach:
            store.add_evaluator(self.evaluate)

    def _target(self, obj: SLObjective) -> tuple[str, float, str]:
        """(series, threshold, bound kind) the forecast runs against."""
        if obj.kind == "rate":
            return (f"slo.burn_rate.{obj.name}", obj.burn_threshold, "upper")
        return (obj.series, obj.objective, obj.kind)

    def time_to_breach(self, obj: SLObjective,
                       now: float | None = None) -> tuple[float, dict]:
        """(seconds until the fitted line crosses the threshold, fit
        details).  ``+inf`` when flat/receding/noisy/short-history."""
        series, threshold, kind = self._target(obj)
        detail: dict[str, Any] = {"series": series, "threshold": threshold}
        fit = self.store.trend(series, self.window_s, now=now)
        last = self.store.last(series)
        if fit is None or last is None:
            return float("inf"), detail
        slope, r2, n = fit
        detail.update(slope_per_s=slope, r2=r2, samples=n, last=last)
        if kind == "upper" and last >= threshold:
            return 0.0, detail
        if kind == "lower" and last <= threshold:
            return 0.0, detail
        if n < self.min_samples or r2 < self.min_r2:
            return float("inf"), detail
        approaching = slope > 0 if kind == "upper" else slope < 0
        if not approaching or slope == 0:
            return float("inf"), detail
        return (threshold - last) / slope, detail

    def evaluate(self, store: TimeSeriesStore | None = None,
                 now: float | None = None) -> dict[str, float]:
        """One forecast pass.  Signature matches the store's evaluator
        hook ``fn(store, t)``."""
        if not core.enabled():
            return {}
        if now is None:
            now = time.time()
        self.evaluations += 1
        out: dict[str, float] = {}
        for obj in self.objectives:
            ttb, detail = self.time_to_breach(obj, now)
            out[obj.name] = ttb
            self.registry.gauge(f"forecast.time_to_breach.{obj.name}", ttb)
            if ttb < self.horizon_s:
                self._warn(obj, ttb, detail, now)
        self.last = out
        return out

    def _warn(self, obj: SLObjective, ttb: float, detail: dict,
              now: float) -> None:
        last = self._last_warn_t.get(obj.name)
        if last is not None and now - last < self.breach_cooldown_s:
            return
        self._last_warn_t[obj.name] = now
        self.registry.increment("forecast.breach_warnings")
        tail = self.store.series(detail.get("series", obj.series))[-BUNDLE_TAIL:]
        path = self.flightrec.dump("forecast_breach", extra={
            "objective": obj.name,
            "kind": obj.kind,
            "time_to_breach_s": ttb,
            "horizon_s": self.horizon_s,
            "window_s": self.window_s,
            "fit": detail,
            "series_tail": [[t, v] for t, v in tail],
        })
        self.warnings.append(str(path) if path else "")

    def ttb_seconds(self, name: str) -> float | None:
        """Last computed time-to-breach for objective ``name``, or None
        before the first pass / for an unknown objective.  The ``+inf``
        no-breach-in-sight value passes through unchanged — callers
        (the autoscaler's ``router_signals``) compare against their own
        horizon, and ``inf`` correctly reads as healthy there."""
        return self.last.get(name)

    def status(self) -> dict[str, Any]:
        return {
            "evaluations": self.evaluations,
            "warnings": len(self.warnings),
            "horizon_s": self.horizon_s,
            "time_to_breach": dict(self.last),
        }
