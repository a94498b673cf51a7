"""The port's multi-replica tier against the reference's (the battery of
``tests/test_router.py``): ring assignments, routing keys, spillover,
breaker quarantine and re-admission, all-down → 503, greedy tokens
through the router over engines, the ``RouterServer`` HTTP surface with
one trace id from the client to the engine, and a CPU ``ProcessReplica``
that matches on tokens and fails fast after ``kill()``.

The engines are a tiny config (vocab 64, d 32, 2 layers) whose weights
come from the reference's init through ``models/convert.py``.
"""

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.serving import engine as jeng
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.resilience.faults import (FaultSpec,
                                                        inject_faults)
from deeplearning4j_tpu_torch.serving import (EngineReplica, HashRing,
                                              InferenceEngine, PagePool,
                                              PrefixRouter, ProcessReplica,
                                              QueueFull, ReplicaUnavailable,
                                              RouterConfig, RouterServer,
                                              ServingClient, ServingConfig,
                                              ServingError, ServingRejected,
                                              prefix_chain_keys)
from deeplearning4j_tpu_torch.serving.router.procserver import \
    tiny_lm_factory
from deeplearning4j_tpu_torch.serving.router.replicas import Replica, ReplicaPool
from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"
KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=32)
SYSTEM = [5, 9, 13, 2, 30, 41, 8, 19]           # 2 full pages of 4


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, remat=False,
                                 xent_chunk=0, **KW)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, remat=False,
                                 xent_chunk=0, **KW)
    jp = jtr.init_params(jax.random.key(7), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    return (jtr.TransformerLM(jcfg), jp,
            ttr.TransformerLM(tcfg, device=CPU), tp)


def _expected(tmodel, tp, prompt, n):
    """The port's offline greedy output."""
    return tmodel.sample(tp, prompt, n, temperature=0.0)[len(prompt):]


def _engines(tmodel, tp, n, **kw):
    base = dict(slots=2, resolve_every=2, paged=True, page_size=4,
                prefix_cache=True)
    base.update(kw)
    out = [InferenceEngine(tmodel, tp, cfg=ServingConfig(**base), device=CPU)
           for _ in range(n)]
    for e in out:
        e.start(warmup=False)
    return [EngineReplica(f"r{i}", e, own_engine=True)
            for i, e in enumerate(out)]


# --------------------------------------------------------------------- ring
def test_ring_assigns_keys_as_the_reference():
    """10,000 keys on 5 nodes (and after a join and a leave): the same
    owner and the same walk order as the reference's ring."""
    names = [f"r{i}" for i in range(5)]
    port, ref = HashRing(names), jrouter.HashRing(names)
    keys = [f"key-{i}" for i in range(10_000)]
    assert [port.primary(k) for k in keys] == [ref.primary(k) for k in keys]
    for ring in (port, ref):
        ring.add("r-new")
        ring.remove("r2")
    assert [port.primary(k) for k in keys] == [ref.primary(k) for k in keys]
    assert [list(port.walk(k)) for k in keys[:200]] == \
        [list(ref.walk(k)) for k in keys[:200]]


def test_ring_walk_yields_every_node_once():
    ring = HashRing([f"r{i}" for i in range(5)])
    order = list(ring.walk("some-key"))
    assert sorted(order) == [f"r{i}" for i in range(5)]
    assert order == list(ring.walk("some-key"))


def test_ring_add_remaps_only_to_new_node():
    n = 8
    ring = HashRing([f"r{i}" for i in range(n)])
    keys = [f"key-{i}" for i in range(2000)]
    before = {k: ring.primary(k) for k in keys}
    ring.add("r-new")
    moved = {k for k in keys if ring.primary(k) != before[k]}
    assert all(ring.primary(k) == "r-new" for k in moved)
    assert len(moved) / len(keys) <= 2.0 / (n + 1)


def test_ring_remove_remaps_only_the_removed_nodes_keys():
    ring = HashRing([f"r{i}" for i in range(8)])
    keys = [f"key-{i}" for i in range(2000)]
    before = {k: ring.primary(k) for k in keys}
    ring.remove("r3")
    for k in keys:
        if before[k] != "r3":
            assert ring.primary(k) == before[k]


# -------------------------------------------------------------- routing key
class _StubReplica(Replica):
    """A replica that answers at once; ``fail_with`` forces errors."""

    def __init__(self, name):
        super().__init__(name)
        self.calls = 0
        self.fail_with = None

    def generate(self, payload, timeout_s):
        self.calls += 1
        if self.fail_with is not None:
            raise self.fail_with
        return {"tokens": [1], "finish_reason": "length",
                "latency_s": 0.0, "ttft_s": 0.0}

    def healthz(self, timeout_s):
        if self.fail_with is not None:
            raise self.fail_with
        return {"ok": True, "engine": {}}


class _JStub(jrouter.Replica):
    def generate(self, payload, timeout_s):
        return {"tokens": [1]}

    def healthz(self, timeout_s):
        return {"ok": True, "engine": {}}


def _stub_router(n=4, **cfg_kw):
    kw = dict(page_size=4, affinity_pages=2, fail_threshold=2,
              recover_threshold=1)
    kw.update(cfg_kw)
    stubs = [_StubReplica(f"r{i}") for i in range(n)]
    return PrefixRouter(stubs, RouterConfig(**kw)), stubs


@pytest.mark.parametrize("page_size,affinity", [(4, 2), (16, 4), (8, 1)])
def test_routing_key_equals_the_reference(page_size, affinity):
    """The same prompts give the same key and the same route order in
    both packages (chain keys, the affinity truncation, the short-prompt
    fallback)."""
    names = [f"r{i}" for i in range(4)]
    port = PrefixRouter([_StubReplica(n) for n in names],
                        RouterConfig(page_size=page_size,
                                     affinity_pages=affinity))
    ref = jrouter.PrefixRouter([_JStub(n) for n in names],
                               jrouter.RouterConfig(page_size=page_size,
                                                    affinity_pages=affinity))
    rng = np.random.default_rng(page_size + affinity)
    prompts = [rng.integers(0, 1000, int(rng.integers(1, 90))).tolist()
               for _ in range(200)]
    for p in prompts:
        key = port.routing_key(p)
        assert key == ref.routing_key(p)
        assert port.route_order(key) == ref.route_order(key)


def test_routing_key_matches_pool_chain_hash():
    tokens = list(range(40))
    pool = PagePool(num_pages=16, page_size=4)
    assert pool.chain_keys(tokens, 39) == prefix_chain_keys(tokens, 39, 4)


def test_routing_key_affinity_prefix_stability():
    router = PrefixRouter([_StubReplica("r0")],
                          RouterConfig(page_size=4, affinity_pages=2))
    k1 = router.routing_key(SYSTEM + [1, 2, 3])
    k2 = router.routing_key(SYSTEM + [9, 10, 11, 12, 13])
    assert k1 == k2
    assert k1 in prefix_chain_keys(SYSTEM + [1, 2, 3], 10, 4)
    short = router.routing_key([1, 2])
    assert short.startswith("short:")
    assert short != router.routing_key([1, 3])


# ------------------------------------------------------------ breaker stubs
def test_spillover_on_429_preserves_availability():
    router, stubs = _stub_router()
    prompt = list(range(12))
    owner = router.route_order(router.routing_key(prompt))[0]
    stubs[int(owner[1:])].fail_with = QueueFull("shedding")
    out = router.generate(prompt, 4)
    assert out["spills"] == 1
    assert out["replica"] == router.route_order(router.routing_key(prompt))[1]
    snap = tobs.METRICS.snapshot()
    assert snap["counters"].get("router.spillover") == 1
    assert snap["counters"].get("router.prefix_affinity_hit") is None
    assert router.pool.is_active(owner)      # 429: alive but full
    router.close()


def test_quarantine_and_readmit_restore_assignment():
    router, stubs = _stub_router(fail_threshold=2)
    prompt = list(range(12))
    key = router.routing_key(prompt)
    original = router.route_order(key)
    owner = original[0]
    stub = stubs[int(owner[1:])]
    stub.fail_with = ReplicaUnavailable(f"replica {owner} wedged")
    for _ in range(2):
        assert router.generate(prompt, 4)["replica"] == original[1]
    assert not router.pool.is_active(owner)
    assert router.route_order(key) == original[1:]
    router.pool.probe_once()
    assert not router.pool.is_active(owner)
    stub.fail_with = None
    router.pool.probe_once()
    assert router.pool.is_active(owner)
    assert router.route_order(key) == original
    assert router.generate(prompt, 4)["replica"] == owner
    snap = tobs.METRICS.snapshot()
    assert snap["counters"].get("router.quarantines") == 1
    assert snap["counters"].get("router.readmissions") == 1
    router.close()


def test_quarantine_dumps_flightrec_bundle_naming_replica():
    router, stubs = _stub_router(fail_threshold=1)
    router.pool.probe_once()
    prompt = list(range(12))
    owner = router.route_order(router.routing_key(prompt))[0]
    stubs[int(owner[1:])].fail_with = ReplicaUnavailable("dead")
    router.generate(prompt, 4)
    bundles = sorted(tobs.FLIGHTREC.dump_dir.glob(
        "flightrec-router_replica_quarantine-*.json"))
    assert bundles
    bundle = json.loads(bundles[-1].read_text())
    assert bundle["extra"]["replica"] == owner
    assert bundle["extra"]["last_probe"]
    router.close()


def test_all_replicas_down_is_503_not_a_hang():
    router, stubs = _stub_router(n=2, fail_threshold=1)
    for s in stubs:
        s.fail_with = ReplicaUnavailable("down")
    t0 = time.monotonic()
    with pytest.raises(ServingRejected) as ei:
        router.generate(list(range(12)), 4)
    assert ei.value.status == 503
    assert time.monotonic() - t0 < 5.0
    router.close()


def test_spillover_burst_dumps_bundle():
    for _ in range(tobs.FLIGHTREC.spill_burst_n):
        path = tobs.FLIGHTREC.note_spillover("r1")
    assert path is not None and path.exists()
    bundle = json.loads(path.read_text())
    assert bundle["trigger"] == "router_spillover_burst"
    assert "r1" in bundle["extra"]["recent_replicas"]


def test_injected_route_fault_maps_to_503():
    router, _ = _stub_router()
    with inject_faults(FaultSpec("router.route", probability=1.0)):
        with pytest.raises(Exception) as ei:
            router.generate(list(range(12)), 4)
    assert "router.route" in str(ei.value)
    router.close()


# ---------------------------------------------------------- engines
def test_greedy_tokens_through_the_router_equal_the_reference(models):
    """Three requests of one tenant through two engines behind each
    package's router: the same tokens, one replica (affinity), and the
    pool-weighted hit rate from a probe sweep."""
    jmodel, jp, tmodel, tp = models
    jengines = [jeng.InferenceEngine(jmodel, params=jp,
                                     cfg=jeng.ServingConfig(
                                         slots=2, resolve_every=2,
                                         paged=True, page_size=4,
                                         prefix_cache=True,
                                         min_prefill_bucket=32))
                for _ in range(2)]
    for e in jengines:
        e.start(warmup=False)
    jr = jrouter.PrefixRouter(
        [jrouter.EngineReplica(f"r{i}", e, own_engine=True)
         for i, e in enumerate(jengines)],
        jrouter.RouterConfig(page_size=4, affinity_pages=2))
    tr = PrefixRouter(_engines(tmodel, tp, 2),
                      RouterConfig(page_size=4, affinity_pages=2))
    try:
        prompts = [SYSTEM + tail for tail in ([3], [7, 11], [22, 1, 60])]
        want = [jr.generate(p, 5, temperature=0.0) for p in prompts]
        got = [tr.generate(p, 5, temperature=0.0) for p in prompts]
        assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
        assert [g["replica"] for g in got] == [w["replica"] for w in want]
        assert len({g["replica"] for g in got}) == 1
        assert all(g["spills"] == 0 for g in got)
        for p, g in zip(prompts, got):
            assert g["tokens"] == _expected(tmodel, tp, p, 5)
        assert tobs.METRICS.snapshot()["counters"][
            "router.prefix_affinity_hit"] == 3
        tr.pool.probe_once()
        assert tobs.METRICS.snapshot()["gauges"][
            "router.prefix_hit_rate"] > 0.0
    finally:
        tr.close()
        jr.close()


def test_spilled_requests_keep_token_parity(models):
    _, _, tmodel, tp = models
    reps = _engines(tmodel, tp, 2, slots=1, paged=False, prefix_cache=False,
                    max_queue=3)
    router = PrefixRouter(reps, RouterConfig(page_size=4, affinity_pages=2))
    plans = [(SYSTEM + [i], 12) for i in range(6)]
    outs, errors = {}, []
    barrier = threading.Barrier(len(plans))

    def fire(idx, prompt, n):
        barrier.wait()
        try:
            outs[idx] = router.generate(prompt, n, temperature=0.0)
        except BaseException as e:   # noqa: BLE001 - asserted below
            errors.append(e)

    ts = [threading.Thread(target=fire, args=(i, *p))
          for i, p in enumerate(plans)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60.0)
    router.close()
    assert not errors, errors
    assert len(outs) == len(plans)
    assert any(o["spills"] > 0 for o in outs.values())
    assert tobs.METRICS.snapshot()["counters"]["router.spillover"] >= 1
    for idx, (prompt, n) in enumerate(plans):
        assert outs[idx]["tokens"] == _expected(tmodel, tp, prompt, n)


def test_chaos_replica_down_quarantine_and_readmission(models):
    _, _, tmodel, tp = models
    router = PrefixRouter(_engines(tmodel, tp, 4), RouterConfig(
        page_size=4, affinity_pages=2, fail_threshold=1, recover_threshold=1,
        probe_interval_s=0.05)).start()
    try:
        prompts = ([5, 9, 13, 2, 30, 41, 8, 19, 3],
                   [1, 1, 2, 3, 5, 8, 13, 21, 34],
                   [60, 59, 58, 57, 56, 55, 54, 53, 2],
                   [7, 7, 7, 7, 7, 7, 7, 7, 7])
        owners = {tuple(p): router.route_order(router.routing_key(p))[0]
                  for p in prompts}
        victim_prompt = list(prompts[0])
        victim = owners[tuple(victim_prompt)]
        other = next(list(p) for p, o in owners.items() if o != victim)
        with inject_faults(FaultSpec("router.replica_down", probability=1.0,
                                     max_fires=0, kind=victim)):
            t0 = time.monotonic()
            out = router.generate(victim_prompt, 4, temperature=0.0)
            assert time.monotonic() - t0 < 10.0
            assert out["replica"] != victim and out["spills"] in (0, 1)
            assert out["tokens"] == _expected(tmodel, tp, victim_prompt, 4)
            assert not router.pool.is_active(victim)
            out2 = router.generate(other, 4, temperature=0.0)
            assert out2["replica"] == owners[tuple(other)]
            assert out2["spills"] == 0
        deadline = time.monotonic() + 5.0
        while not router.pool.is_active(victim) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert router.pool.is_active(victim)
        assert router.generate(victim_prompt, 4)["replica"] == victim
        assert list(tobs.FLIGHTREC.dump_dir.glob(
            "flightrec-router_replica_quarantine-*.json"))
    finally:
        router.close()


# ------------------------------------------------------------------ HTTP
def test_router_server_http_surface(models):
    _, _, tmodel, tp = models
    router = PrefixRouter(_engines(tmodel, tp, 2),
                          RouterConfig(page_size=4, affinity_pages=2,
                                       probe_interval_s=0.05))
    prompt = [5, 9, 13, 2, 30, 41, 8, 19, 3]
    with RouterServer(router) as server:
        client = ServingClient(port=server.port)
        with tobs.trace.span("client.generate") as sp:
            out = client.generate(prompt, 5, temperature=0.0, tenant="acme")
        assert out["tokens"] == _expected(tmodel, tp, prompt, 5)
        assert out["replica"] in ("r0", "r1") and out["spills"] == 0
        names = [ev["name"] for ev in tobs.TRACER.to_chrome_trace()
                 ["traceEvents"]
                 if (ev.get("args") or {}).get("trace_id") == sp.trace_id]
        assert {"client.generate", "router.request", "router.route",
                "serving.queue_wait", "serving.prefill",
                "serving.decode.segment", "serving.emit",
                "serving.request"} <= set(names)
        counters = tobs.METRICS.snapshot()["counters"]
        assert counters["tenant.acme.prompt_tokens"] == len(prompt)
        assert counters["tenant.acme.generated_tokens"] == 5
        health = client.healthz()
        assert health["ok"] and set(health["replicas"]) == {"r0", "r1"}
        assert all(v["active"] for v in health["replicas"].values())
        prom = client.metrics_prom()
        assert "router_requests_total" in prom
        assert "router_replica_state_r0" in prom
        with pytest.raises(ServingError) as ei:
            client.generate([999], 4)
        assert ei.value.status == 400
        with pytest.raises(ServingError) as ei2:
            client._json("/v1/reload", {})
        assert ei2.value.status == 409


# ------------------------------------------------------- process replicas
def test_process_replica_parity_and_fail_fast(tmp_path):
    """A child process building ``tiny_lm_factory``'s engine on the CPU
    serves the same greedy tokens as the same factory's model here; after
    ``kill()`` the router answers 503 at once and quarantines it."""
    kw = {"max_len": 32, "slots": 2, "paged": True, "page_size": 4,
          "prefix_cache": True, "device": CPU}
    local = tiny_lm_factory(**kw)
    rep = ProcessReplica(
        "p0", "deeplearning4j_tpu_torch.serving.router.procserver:"
        "tiny_lm_factory", tmp_path, factory_kwargs=kw,
        client_timeout_s=30.0)
    router = PrefixRouter([rep], RouterConfig(page_size=4, affinity_pages=2,
                                              fail_threshold=1))
    try:
        prompt = [5, 9, 13, 2, 30, 41, 8, 19, 3]
        out = router.generate(prompt, 5, temperature=0.0)
        assert out["tokens"] == local.model.sample(
            local._raw_params, prompt, 5, temperature=0.0)[len(prompt):]
        assert out["replica"] == "p0"
        health = rep.healthz(5.0)
        assert health["ok"] and health["engine"]["prefix_lookups"] >= 1
        assert health["warmed"] and health["role"] == "unified"
        rep.kill()
        t0 = time.monotonic()
        with pytest.raises(ServingRejected) as ei:
            router.generate(prompt, 5, temperature=0.0)
        assert ei.value.status == 503
        assert time.monotonic() - t0 < 15.0
        assert not router.pool.is_active("p0")
    finally:
        router.close()


def test_tiny_lm_factory_refuses_the_disagg_roles():
    """The factory builds a prefill-tier engine (paged forced on, no serve
    thread), as the reference's does; the pool's prober refuses it as a
    decode target, beside a unified engine it keeps."""
    pf = tiny_lm_factory(role="prefill", device=CPU)
    assert pf.cfg.paged and pf.stats()["role"] == "prefill"
    pf.start(warmup=False)
    assert not pf.stats()["running"]
    uni = tiny_lm_factory(device=CPU)
    pool = ReplicaPool([EngineReplica("pf", pf), EngineReplica("uni", uni)],
                       fail_threshold=1)
    pool.probe_once()
    assert not pool.is_active("pf") and pool.is_active("uni")


# --------------------------------------------------------- client transport
class _FlakyHandler(BaseHTTPRequestHandler):
    """Resets the first ``fail_gets`` GET connections; counts POSTs."""

    fail_gets = {"n": 1}
    posts = {"n": 0}

    def log_message(self, *a):
        pass

    def do_GET(self):
        if self.fail_gets["n"] > 0:
            self.fail_gets["n"] -= 1
            self.connection.close()
            return
        body = b'{"ok": true}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        self.posts["n"] += 1
        self.connection.close()


def test_client_retries_idempotent_gets_only():
    _FlakyHandler.fail_gets["n"] = 1
    _FlakyHandler.posts["n"] = 0
    server = ThreadingHTTPServer(("127.0.0.1", 0), _FlakyHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServingClient(port=server.server_address[1], timeout_s=5.0,
                               retries=1, retry_backoff_s=0.01)
        assert client.healthz() == {"ok": True}
        with pytest.raises(OSError):
            client.generate([1, 2, 3], 4)
        assert _FlakyHandler.posts["n"] == 1
    finally:
        server.shutdown()
        thread.join(timeout=10.0)
        server.server_close()


def test_client_timeout_is_bounded():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    try:
        client = ServingClient(port=sock.getsockname()[1], timeout_s=60.0,
                               retries=0)
        t0 = time.monotonic()
        with pytest.raises(OSError):
            client.healthz(timeout_s=0.5)
        assert time.monotonic() - t0 < 5.0
    finally:
        sock.close()
