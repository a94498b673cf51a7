"""Serving parity: the port's engine against the JAX package's engine.

Both engines get the same parameters (through numpy), the same
``ServingConfig`` and the same concurrent greedy requests, in float32 on
the CPU; the served tokens must be identical.  Sampled requests are held
to the port's own offline sampler.  The HTTP round trip, the queue and
page-pool bookkeeping and the hot-loop rule are checked on the port
alone.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.serving import engine as jeng
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.serving import (InferenceEngine, ModelServer,
                                              PagePool, PagePoolExhausted,
                                              QueueFull, RequestQueue,
                                              ServingClient, ServingConfig,
                                              ServingError, kv_page_bytes)
from deeplearning4j_tpu_torch.serving.batcher import GenerateRequest
from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"
KW = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=32)
PROMPTS = [[3, 14, 15], [9, 2, 6, 5, 35], [8], [27, 18, 28, 18, 28, 45, 9],
           [1, 1, 2, 3, 5, 8]]
NEW = [7, 5, 9, 4, 6]


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **KW)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **KW)
    jp = jtr.init_params(jax.random.key(3), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    return (jtr.TransformerLM(jcfg), jp,
            ttr.TransformerLM(tcfg, device=CPU), tp)


def _serve(engine):
    with engine:
        handles = [engine.submit(p, n) for p, n in zip(PROMPTS, NEW)]
        return [h.result(timeout=120).tokens for h in handles]


@pytest.mark.parametrize("kv_quant,impl", [(None, "pallas"),
                                           ("int8", "pallas_int8"),
                                           ("fp8", "pallas_int8")])
def test_served_greedy_tokens_identical_to_jax_engine(models, kv_quant, impl):
    jmodel, jp, tmodel, tp = models
    common = dict(slots=4, paged=True, page_size=4, int8_decode=True,
                  paged_attention_impl=impl, kv_quant=kv_quant,
                  min_prefill_bucket=32, resolve_every=3)
    want = _serve(jeng.InferenceEngine(jmodel, params=jp,
                                       cfg=jeng.ServingConfig(**common)))
    engine = InferenceEngine(tmodel, tp, cfg=ServingConfig(**common),
                             device=CPU)
    got = _serve(engine)
    assert got == want
    assert [len(t) for t in got] == NEW
    stats = engine.stats()
    assert stats["completed"] == len(PROMPTS) and stats["free"] == 4
    assert stats["kv_pages_in_use"] == 0     # every page went back


def test_dense_engine_and_sampling_match_offline_sampler(models):
    """Dense engine: greedy and sampled requests equal the port's offline
    ``TransformerLM.sample`` with the same seed."""
    _, _, tmodel, tp = models
    engine = InferenceEngine(tmodel, tp, cfg=ServingConfig(slots=2),
                             device=CPU)
    reqs = [([4, 5, 6], 6, 0.0, 0), ([7, 8], 5, 0.8, 21),
            ([9, 10, 11, 12], 4, 1.3, 5)]
    with engine:
        handles = [engine.submit(p, n, temperature=t, seed=s)
                   for p, n, t, s in reqs]
        got = [h.result(timeout=120).tokens for h in handles]
    for (p, n, t, s), toks in zip(reqs, got):
        assert toks == tmodel.sample(tp, p, n, temperature=t, seed=s)[len(p):]


def test_decode_segment_makes_no_host_sync(models, monkeypatch):
    """The hot-loop rule: between fences no ``.item()``, ``.cpu()`` or
    ``.tolist()`` — emitted tokens stay on the device until _resolve."""
    _, _, tmodel, tp = models
    engine = InferenceEngine(
        tmodel, tp, cfg=ServingConfig(slots=2, paged=True, page_size=4,
                                      int8_decode=True,
                                      paged_attention_impl="pallas"),
        device=CPU)
    real = engine._decode_segment
    calls = []

    def guarded():
        def boom(*a, **k):
            raise AssertionError("host sync inside the decode segment")
        with monkeypatch.context() as m:
            for name in ("item", "cpu", "tolist", "numpy"):
                m.setattr(torch.Tensor, name, boom)
            out = real()
        calls.append(len(out))
        return out

    engine._decode_segment = guarded
    with engine:
        toks = engine.generate([1, 2, 3], 6, temperature=0.7, seed=1).tokens
    assert calls and len(toks) == 6


def test_model_server_client_round_trip(models):
    _, _, tmodel, tp = models
    engine = InferenceEngine(tmodel, tp, cfg=ServingConfig(
        slots=2, paged=True, page_size=4), device=CPU)
    with engine, ModelServer(engine) as server:
        client = ServingClient(port=server.port, timeout_s=60)
        out = client.generate([5, 6, 7], max_new_tokens=4)
        assert out["tokens"] == tmodel.sample(tp, [5, 6, 7], 4,
                                              temperature=0.0)[3:]
        assert out["finish_reason"] == "length" and out["ttft_s"] > 0
        health = client.healthz()
        assert health["ok"] and health["engine"]["completed"] == 1
        assert client.metrics()["counters"]["serving.tokens"] == 4
        prom = client.metrics_prom()
        assert "serving_tokens_total 4.0" in prom
        assert "# TYPE serving_decode_step_seconds histogram" in prom
        with pytest.raises(ServingError) as e:
            client.generate([], max_new_tokens=2)
        assert e.value.status == 400
        with pytest.raises(ServingError) as e:
            client.generate([1], max_new_tokens=40)
        assert e.value.status == 400


def test_page_pool_and_engine_backpressure(models):
    pool = PagePool(4, 2)
    a = pool.alloc(3)
    with pytest.raises(PagePoolExhausted):
        pool.alloc(2)
    assert [pool.refcount(p) for p in a] == [1, 1, 1]
    assert pool.decref(a[:1]) == a[:1] and pool.in_use() == 2
    assert pool.refcount(a[0]) == 0
    with pytest.raises(AssertionError):
        pool.decref(a[:1])
    # a pool too small for a request rejects it (429) and keeps serving
    _, _, tmodel, tp = models
    engine = InferenceEngine(tmodel, tp, cfg=ServingConfig(
        slots=2, paged=True, page_size=4, num_pages=3), device=CPU)
    with engine:
        big = engine.submit(list(range(1, 13)), 4)       # needs 4 pages
        ok = engine.submit([1, 2], 3)
        with pytest.raises(PagePoolExhausted):
            big.result(timeout=60)
        assert len(ok.result(timeout=60).tokens) == 3
    assert tobs.METRICS.snapshot()["counters"][
        "serving.page_pool_exhausted"] == 1
    mcfg = tmodel.cfg
    assert kv_page_bytes(mcfg, 4, "int8") == (4 * 4 * 8 * 2 + 2 * 4 * 4) * 2


@pytest.mark.parametrize("kw,exc", [
    (dict(role="bogus"), ValueError),                 # not a role
    (dict(kv_quant="fp8"), ValueError),               # needs paged pages
    (dict(role="prefill"), ValueError),               # needs paged pages
    (dict(kv_quant="int8"), ValueError),              # needs paged pages
    (dict(paged=True, kv_quant="int4"), ValueError),  # not a mode
])
def test_engine_refuses_what_is_not_ported(models, kw, exc):
    """The configurations the reference refuses, refused alike (fp8 pages
    are served: test_served_greedy_tokens_identical_to_jax_engine)."""
    _, _, tmodel, tp = models
    with pytest.raises(exc):
        InferenceEngine(tmodel, tp, cfg=ServingConfig(**kw), device=CPU)


def test_request_queue_bounds_deadlines_and_tiers():
    q = RequestQueue(max_depth=3, max_batch_delay_ms=0)
    bg = q.submit(GenerateRequest([1], 1, priority=1))
    fg = q.submit(GenerateRequest([2], 1))
    live = q.submit(GenerateRequest([3], 1,
                                    deadline_s=time.monotonic() + 100))
    with pytest.raises(QueueFull):
        q.submit(GenerateRequest([4], 1))
    assert q.take(3) == [fg, live, bg]
    dead = q.submit(GenerateRequest([5], 1, deadline_s=time.monotonic() - 1))
    assert q.depth() == 0 and dead.done()
    assert tobs.METRICS.snapshot()["counters"]["serving.deadline_dropped"] == 1
    # an interactive arrival preempts a background claim
    q.submit(GenerateRequest([6], 1))
    assert not q.claim(bg) and q.depth() == 2
    assert q.claim(fg)
    ev = threading.Event()
    t = threading.Thread(target=lambda: (q.take(5, block_s=5.0), ev.set()))
    t.start()
    t.join(timeout=10)
    assert ev.is_set() and not t.is_alive()
