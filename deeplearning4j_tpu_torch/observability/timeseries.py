"""Time-series telemetry: the registry, sampled on a clock.

Port of ``deeplearning4j_tpu/observability/timeseries.py``.
:class:`TimeSeriesStore` samples every counter, gauge and histogram
quantile of a registry at a fixed interval on a daemon thread into a
bounded ring per series, and appends each sample row to a JSONL file under
``DL4J_TPU_TS_DIR`` (or ``out_dir``) so the history survives the process.

- Disabled is free: ``start()`` spawns no thread while observability is
  off, and ``sample_once()`` returns before touching any lock.
- The registry snapshot is taken before the store lock, so the two locks
  never nest; evaluators (the SLO tier) run after the store lock is
  released.
- Each series keeps at most ``ring`` points; evictions are counted per
  series (``dropped`` in :meth:`TimeSeriesStore.stats`).  The JSONL file
  is append-only.
- :func:`read_back` skips a torn final line, so a sampler killed
  mid-write never poisons the reader.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Iterable

from . import core
from .metrics import METRICS, MetricsRegistry

ENV_TS_DIR = "DL4J_TPU_TS_DIR"

# Histogram quantiles sampled per timer series, as (suffix, summary key).
_QUANTILES: tuple[tuple[str, str], ...] = (
    ("p50", "p50_s"), ("p95", "p95_s"), ("p99", "p99_s"))


class TimeSeriesStore:
    """Samples a :class:`MetricsRegistry` into per-series bounded rings.

    Series names are the registry names, with histogram quantiles exposed
    as ``<timer>.p50`` / ``.p95`` / ``.p99``.  Counters are sampled as
    their cumulative value (rates are a reader-side diff).
    """

    def __init__(self, registry: MetricsRegistry = METRICS,
                 interval_s: float = 1.0, ring: int = 512,
                 out_dir: str | os.PathLike | None = None):
        self.registry = registry
        self.interval_s = float(interval_s)
        self.ring = int(ring)
        self._lock = threading.Lock()
        self._series: dict[str, deque[tuple[float, float]]] = {}
        self._dropped: dict[str, int] = {}
        self._samples = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # Called as fn(store, t) after each sample, outside the store lock
        # (the SLO evaluator hangs off this hook — scrape-free path).
        self._evaluators: list[Callable[["TimeSeriesStore", float], None]] = []
        d = out_dir if out_dir is not None else os.environ.get(ENV_TS_DIR)
        self.out_path: Path | None = None
        if d:
            p = Path(d)
            p.mkdir(parents=True, exist_ok=True)
            self.out_path = p / f"timeseries-{os.getpid()}.jsonl"

    # ------------------------------------------------------------ lifecycle
    def start(self) -> bool:
        """Spawn the sampler daemon.  Returns False (and spawns nothing)
        when observability is disabled or the thread is already running."""
        if not core.enabled():
            return False
        if self._thread is not None and self._thread.is_alive():
            return False
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dl4j-torch-timeseries", daemon=True)
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
                self.sample_once()
            except Exception:
                pass  # a sampler must never take the process down

    # ------------------------------------------------------------- sampling
    def add_evaluator(self, fn: Callable[["TimeSeriesStore", float], None]) -> None:
        self._evaluators.append(fn)

    def sample_once(self, t: float | None = None) -> int:
        """Take one sample of every registered series.  Returns the number
        of series sampled (0 while disabled — and no work was done)."""
        if not core.enabled():
            return 0
        snap = self.registry.snapshot()  # registry lock; released before ours
        if t is None:
            t = time.time()
        row: dict[str, float] = {}
        for name, v in snap["counters"].items():
            row[name] = float(v)
        for name, v in snap["gauges"].items():
            row[name] = float(v)
        for name, summ in snap["timers"].items():
            for suffix, key in _QUANTILES:
                v = summ[key]
                if v == v:  # skip NaN quantiles (empty window)
                    row[f"{name}.{suffix}"] = float(v)
        with self._lock:
            self._samples += 1
            for name, v in row.items():
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = deque(maxlen=self.ring)
                if len(ring) == self.ring:
                    self._dropped[name] = self._dropped.get(name, 0) + 1
                ring.append((t, v))
        if self.out_path is not None and row:
            try:
                with open(self.out_path, "a") as f:
                    f.write(json.dumps({"t": t, "series": row}) + "\n")
            except OSError:
                pass
        for fn in self._evaluators:
            try:
                fn(self, t)
            except Exception:
                pass
        return len(row)

    # -------------------------------------------------------------- reading
    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, name: str) -> list[tuple[float, float]]:
        """Ring contents for one series, oldest first (copy)."""
        with self._lock:
            ring = self._series.get(name)
            return list(ring) if ring else []

    def last(self, name: str) -> float | None:
        with self._lock:
            ring = self._series.get(name)
            return ring[-1][1] if ring else None

    def window(self, name: str, seconds: float,
               now: float | None = None) -> list[tuple[float, float]]:
        """Points within the trailing ``seconds`` of ``now``."""
        pts = self.series(name)
        if not pts:
            return []
        if now is None:
            now = pts[-1][0]
        lo = now - seconds
        return [(t, v) for t, v in pts if t >= lo]

    def trend(self, name: str, window_s: float,
              now: float | None = None) -> tuple[float, float, int] | None:
        """Least-squares line fit over the trailing ``window_s`` of one
        series: ``(slope_per_second, r_squared, n_samples)``, or ``None``
        with fewer than two points (or zero time spread).  A perfectly
        flat series fits its own flat line exactly (slope 0, R² 1) — the
        forecast tier reads that as "never breaching", not "no data".
        """
        pts = self.window(name, window_s, now)
        n = len(pts)
        if n < 2:
            return None
        mt = sum(t for t, _ in pts) / n
        mv = sum(v for _, v in pts) / n
        sxx = sum((t - mt) ** 2 for t, _ in pts)
        if sxx <= 0.0:
            return None  # all points at one instant: slope undefined
        sxy = sum((t - mt) * (v - mv) for t, v in pts)
        syy = sum((v - mv) ** 2 for _, v in pts)
        slope = sxy / sxx
        r2 = (sxy * sxy) / (sxx * syy) if syy > 0.0 else 1.0
        return slope, r2, n

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "samples": self._samples,
                "series": len(self._series),
                "dropped": dict(self._dropped),
                "dropped_total": sum(self._dropped.values()),
            }

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._dropped.clear()
            self._samples = 0


def read_back(path: str | os.PathLike) -> list[dict[str, Any]]:
    """Read a time-series JSONL file, tolerating a torn final line (the
    sampler may have been killed mid-append).  A torn line anywhere else
    is also skipped — readers want the history, not an exception."""
    rows: list[dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict) and "series" in row:
                    rows.append(row)
    except OSError:
        return []
    return rows


def read_back_series(paths: Iterable[str | os.PathLike]) -> dict[str, list[tuple[float, float]]]:
    """Merge one or more JSONL files into ``{name: [(t, value), ...]}``
    sorted by time — the shape ``metrics_dump --timeline`` renders."""
    out: dict[str, list[tuple[float, float]]] = {}
    for path in paths:
        for row in read_back(path):
            t = float(row.get("t", 0.0))
            for name, v in row["series"].items():
                try:
                    out.setdefault(name, []).append((t, float(v)))
                except (TypeError, ValueError):
                    continue
    for pts in out.values():
        pts.sort(key=lambda p: p[0])
    return out
