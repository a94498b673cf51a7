"""The port's fleet observability against the reference's: Prometheus
parsing of both packages' exposition text, federation staleness, the
scraper's rollups, bounded tenant labels, least-squares forecasts, the
status server's routes, and the federation of a real process replica.
"""

import json
import math
import urllib.request

import numpy as np
import pytest

import deeplearning4j_tpu.observability as jobs
from deeplearning4j_tpu.observability import fleet as jfleet
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.observability import fleet as tfleet
from deeplearning4j_tpu_torch.serving import (PrefixRouter, ProcessReplica,
                                              RouterConfig)
from torch_port_obs import port_obs  # noqa: F401  (autouse)

PKGS = {"port": tobs, "ref": jobs}


class StubReplica:
    """``body``: a string, a callable returning one, or an exception."""

    def __init__(self, name, body):
        self.name = name
        self.body = body

    def metrics_prom(self, timeout_s):
        b = self.body() if callable(self.body) else self.body
        if isinstance(b, Exception):
            raise b
        return b


class StubPool:
    def __init__(self, replicas, inactive=()):
        self._reps = {r.name: r for r in replicas}
        self.inactive = set(inactive)

    def names(self):
        return list(self._reps)

    def is_active(self, name):
        return name not in self.inactive

    def replica(self, name):
        return self._reps[name]


def _fill(reg, seed):
    """The same seeded counters, gauges and timings into a registry."""
    rng = np.random.default_rng(seed)
    for i in range(6):
        reg.increment(f"serving.c{i}", float(rng.integers(1, 100)))
        reg.gauge(f"serving.g{i}.x", float(rng.normal()))
        for _ in range(5):
            reg.observe_time(f"serving.t{i}", float(rng.uniform(1e-4, 2.0)))
    reg.gauge("serving.nan", float("nan"))
    reg.gauge("serving.inf", float("inf"))
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_parse_prometheus_equals_the_reference(seed):
    """Both packages' exposition text, parsed by both packages' parsers:
    four equal dicts (NaN compared as NaN)."""
    texts = [_fill(P.MetricsRegistry(), seed).to_prometheus()
             for P in PKGS.values()]
    parsed = [P.parse_prometheus(t) for t in texts for P in PKGS.values()]
    canon = [json.dumps(p, sort_keys=True, default=str) for p in parsed]
    assert len(set(canon)) == 1
    one = parsed[0]
    assert one["counters"]["serving_c0"] > 0
    assert math.isnan(one["gauges"]["serving_nan"])
    assert one["histograms"]["serving_t0"]["count"] == 5.0


def test_parse_tolerates_torn_bodies_and_garbage():
    full = _fill(tobs.MetricsRegistry(), 0).to_prometheus()
    whole = tobs.parse_prometheus(full)
    for cut in range(0, len(full), 11):
        got = tobs.parse_prometheus(full[:cut])
        ref = jobs.parse_prometheus(full[:cut])
        assert json.dumps(got, sort_keys=True, default=str) == \
            json.dumps(ref, sort_keys=True, default=str)
        # a tear loses series (a value cut mid-digits still parses, as in
        # the reference) but never invents one
        for section in ("counters", "gauges", "histograms"):
            assert set(got[section]) <= set(whole[section])
    assert tobs.parse_prometheus("##\nnot a line {{{\nx_total nan?\n") == {
        "counters": {}, "gauges": {}, "histograms": {}}


def _body(P, tokens, tps):
    reg = P.MetricsRegistry()
    reg.increment("serving.tokens", tokens)
    reg.gauge("serving.tokens_per_sec", tps)
    reg.gauge("serving.queue.depth", 1.0)
    return reg.to_prometheus()


def test_federated_registry_values_and_local_staleness():
    fed = tobs.FederatedRegistry()
    fed.update("a", tobs.parse_prometheus(_body(tobs, 10, 5.0)), t=100.0)
    fed.update("b", tobs.parse_prometheus(_body(tobs, 20, 7.0)), t=100.0)
    assert fed.replicas() == ["a", "b"]
    assert fed.value("serving.tokens", "a") == 10.0
    assert fed.value("serving.tokens_per_sec", "b") == 7.0
    fed.mark_stale("b")
    assert fed.stale_replicas() == ["b"] and fed.stale("b")
    assert fed.values("serving.tokens") == {"a": 10.0, "b": 20.0}
    assert fed.values("serving.tokens_per_sec",
                      include_stale=False) == {"a": 5.0}
    assert fed.age_s("a", now=103.0) == pytest.approx(3.0)
    fed.update("b", tobs.parse_prometheus(_body(tobs, 25, 6.0)))
    assert fed.stale_replicas() == []
    fed.forget("b")
    assert fed.replicas() == ["a"]
    assert fed.snapshot()["replicas"]["a"]["counters"]["serving_tokens"] == 10


def test_scraper_rollups_equal_the_reference():
    """One stub fleet (two live replicas, a dead one, a quarantined one and
    an in-process one) scraped twice by each package's scraper, a replica
    dying in between: the same rollups, spreads and staleness."""
    out = {}
    for name, P in PKGS.items():
        reg = P.MetricsRegistry()
        reg.increment("serving.tokens", 4)            # the in-process one
        health = {"r1": _body(P, 20, 7.0)}
        pool = StubPool([StubReplica("r0", _body(P, 10, 5.0)),
                         StubReplica("r1", lambda h=health: h["r1"]),
                         StubReplica("dead", OSError("refused")),
                         StubReplica("q", _body(P, 99, 9.0)),
                         StubReplica("local", "")], inactive={"q"})
        scraper = P.FleetScraper(pool, registry=reg)
        first = scraper.scrape_once()
        health["r1"] = OSError("replica died")
        second = scraper.scrape_once()
        snap = reg.snapshot()
        out[name] = (first, second, scraper.fed.stale_replicas(),
                     {k: v for k, v in snap["gauges"].items()
                      if k.startswith("fleet.")},
                     {k: v for k, v in snap["counters"].items()
                      if k.startswith("fleet.")})
    assert out["port"] == out["ref"]
    first, second, stale, gauges, counters = out["port"]
    assert (first, second) == (2, 1) and stale == ["dead", "q", "r1"]
    assert gauges["fleet.tokens_total"] == 34.0     # stale counters stay
    assert gauges["fleet.tokens_per_sec"] == 5.0    # stale gauges go
    assert counters["fleet.scrape_errors"] == 3.0


@pytest.mark.parametrize("seed", range(3))
def test_tenant_folding_equals_the_reference(seed):
    """The same arrival order of 60 tenant ids (some repeating) folds the
    same way in both packages: labels, tracked set, overflow count and
    accounted counters."""
    rng = np.random.default_rng(seed)
    arrivals = [f"t{int(i)}" for i in rng.integers(0, 20, 60)] + ["", "__other__"]
    out = {}
    for name, P in PKGS.items():
        reg = P.MetricsRegistry()
        tl = (tfleet if name == "port" else jfleet).TenantLabels(
            registry=reg, max_tenants=8)
        labels = [tl.label(t) for t in arrivals]
        for i, t in enumerate(arrivals):
            tl.account("generated_tokens", t, i)
        out[name] = (labels, tl.tracked(), reg.snapshot()["counters"])
    assert out["port"] == out["ref"]
    labels, tracked, counters = out["port"]
    assert len(tracked) == 8 and "__other__" in labels
    assert not any(k.startswith("tenant.") and k.split(".")[1] not in
                   set(tracked) | {"__other__"} for k in counters)


def _ramp_store(P, values, t0=100.0):
    reg = P.MetricsRegistry()
    store = P.TimeSeriesStore(registry=reg)
    for i, v in enumerate(values):
        reg.gauge("s", v)
        store.sample_once(t=t0 + i)
    return reg, store


@pytest.mark.parametrize("seed", range(4))
def test_forecast_time_to_breach_equals_the_reference(seed):
    """The same noisy ramps (rising, falling, flat) through both packages'
    ``trend`` and ``ForecastEvaluator``: equal fits and times to breach
    (1e-12 relative)."""
    rng = np.random.default_rng(seed)
    slope = float(rng.choice([-0.3, 0.0, 0.05, 0.2]))
    values = [1.0 + slope * i + float(rng.normal(0, 0.02)) for i in range(30)]
    got = {}
    for name, P in PKGS.items():
        reg, store = _ramp_store(P, values)
        objs = [P.SLObjective("up", "upper", "s", 6.0, windows=(8.0,)),
                P.SLObjective("down", "lower", "s", -2.0, windows=(8.0,))]
        rec = P.FlightRecorder(None)
        rec.dump = lambda *a, **k: None
        fore = P.ForecastEvaluator(objs, store, registry=reg, flightrec=rec,
                                   horizon_s=50.0, window_s=20.0,
                                   attach=False)
        got[name] = (store.trend("s", 20.0), fore.evaluate(store, now=129.0),
                     len(fore.warnings))
    (pt, pf, pw), (rt, rf, rw) = got["port"], got["ref"]
    assert pt[2] == rt[2] and pw == rw
    assert pt[:2] == pytest.approx(rt[:2], rel=1e-12, abs=1e-15)
    for k in pf:
        if math.isinf(rf[k]):
            assert pf[k] == rf[k]
        else:
            assert pf[k] == pytest.approx(rf[k], rel=1e-12)


class _Tracker:
    def __init__(self):
        self._counters = {"jobs": 3}

    def workers(self):
        return ["w0", "w1"]

    def is_enabled(self, w):
        if w == "w1":
            raise KeyError("evicted")
        return True

    def last_heartbeat(self, w):
        return 0.0

    def current_jobs(self):
        return [1, 2]

    def updates(self):
        return {"b": 1, "a": 2}

    def is_done(self):
        return False


def test_status_server_routes():
    reg = tobs.MetricsRegistry()
    reg.increment("serving.tokens", 3)
    server = tobs.StatusServer(tracker=_Tracker(), registry=reg).start()
    base = f"http://127.0.0.1:{server.port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.read().decode()

    try:
        assert json.loads(get("/healthz")) == {"ok": True}
        assert json.loads(get("/metrics"))["counters"]["serving.tokens"] == 3
        parsed = tobs.parse_prometheus(get("/metrics.prom"))
        assert parsed["counters"]["serving_tokens"] == 3.0
        status = json.loads(get("/status"))
        assert status["workers"] == ["w0", "w1"]
        assert status["current_jobs"] == 2
        assert status["pending_updates"] == ["a", "b"]
        assert any("evicted" in e for e in status["errors"])
        with pytest.raises(urllib.error.HTTPError) as ei:
            get("/nope")
        assert ei.value.code == 404
    finally:
        server.stop()


def test_scraper_federates_a_process_replica(tmp_path):
    """A CPU ``ProcessReplica`` serves a routed request; the scraper
    federates its ``/metrics.prom`` into ``fleet.tokens_total``; after
    ``kill()`` the scrape fails fast, counts an error and marks it stale."""
    rep = ProcessReplica(
        "p0", "deeplearning4j_tpu_torch.serving.router.procserver:"
        "tiny_lm_factory", tmp_path, factory_kwargs={"device": "cpu",
                                                      "max_len": 32},
        client_timeout_s=30.0)
    router = PrefixRouter([rep], RouterConfig(page_size=16))
    try:
        out = router.generate(list(range(1, 9)), 6, temperature=0.0)
        assert len(out["tokens"]) == 6
        reg = tobs.MetricsRegistry()
        scraper = tobs.FleetScraper(router.pool, registry=reg,
                                    timeout_s=5.0)
        assert scraper.scrape_once() == 1
        assert reg.snapshot()["gauges"]["fleet.tokens_total"] == 6.0
        assert scraper.fed.value("serving.requests", "p0") == 1.0
        rep.kill()
        assert scraper.scrape_once() == 0
        snap = reg.snapshot()
        assert snap["counters"]["fleet.scrape_errors"] == 1.0
        assert scraper.fed.stale_replicas() == ["p0"]
        assert snap["gauges"]["fleet.tokens_total"] == 6.0
    finally:
        router.close()
