"""The port's serving engine publishes what the reference's publishes.

The same requests (three tenants, a shared prefix, paged int8 decode with
the prefix cache) through the reference's engine and the port's give:
the same ``serving.*`` metric names, apart from the differences listed
with their reasons; equal counters; equal tenant accounts; and, behind
each package's ``ModelServer``, the same span names per request under
the one trace id the client's span started.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.observability as jobs
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.serving import ModelServer as JModelServer
from deeplearning4j_tpu.serving import ServingClient as JServingClient
from deeplearning4j_tpu.serving import engine as jeng
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.serving import (InferenceEngine, ModelServer,
                                              QueueFull, ServingClient,
                                              ServingConfig, ServingError)
from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"
KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=32)
COMMON = dict(slots=2, paged=True, page_size=4, int8_decode=True,
              prefix_cache=True, paged_attention_impl="pallas",
              resolve_every=2, min_prefill_bucket=32)
SYSTEM = [5, 9, 13, 2, 30, 41, 8, 19]
REQUESTS = [(SYSTEM + [3], 5, "acme"), (SYSTEM + [7, 7], 4, "acme"),
            ([1, 2, 3], 6, "globex"), (SYSTEM + [11], 3, "initech")]

#: names one engine publishes and the other does not, with the reason
REF_ONLY = {
    "serving.prefill.recompile": "XLA compiles one prefill per prompt "
                                 "bucket; PyTorch runs eagerly (the port "
                                 "keeps the buckets as bookkeeping)",
}
PORT_ONLY = {
    "serving.prefix_cached_tokens": "prompt positions whose prefill the "
                                    "prefix cache saved: the port's "
                                    "prefill is token by token, so this "
                                    "is the work saved (chip_smoke.py "
                                    "derives its launch counts from it)",
    "serving.prefill": "the port times its host-side prefill loop (a "
                       "histogram beside the span), the TTFT layer",
    "serving.generation": "published at construction, so a fresh engine "
                          "reads generation 0; the reference first "
                          "publishes it at a swap",
}
#: counters that hold a time, not a count
TIMED = (".queue_wait_s",)


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
        return [engine.generate(p, n, tenant=t).tokens
                for p, n, t in REQUESTS]


@pytest.fixture
def snapshots(models):
    jmodel, jp, tmodel, tp = models
    jobs.METRICS.reset()
    want = _serve(jeng.InferenceEngine(jmodel, params=jp,
                                       cfg=jeng.ServingConfig(**COMMON)))
    got = _serve(InferenceEngine(tmodel, tp, cfg=ServingConfig(**COMMON),
                                 device=CPU))
    assert got == want
    return jobs.METRICS.snapshot(), tobs.METRICS.snapshot()


def _names(snap):
    return {name for section in ("counters", "gauges", "timers")
            for name in snap[section]}


def test_the_same_serving_metric_names(snapshots):
    ref, port = snapshots
    rn, pn = _names(ref), _names(port)
    assert rn - pn == set(REF_ONLY)
    assert pn - rn == set(PORT_ONLY)
    assert {"serving.decode_mfu", "serving.decode_mbu",
            "serving.prefix_hit_rate", "serving.queue_wait",
            "serving.ttft"} <= rn & pn


def test_equal_counters_and_tenant_accounts(snapshots):
    ref, port = snapshots
    rc, pc = ref["counters"], port["counters"]
    for name in ("serving.requests", "serving.admitted", "serving.completed",
                 "serving.tokens", "serving.prefix_hits"):
        assert pc[name] == rc[name] > 0, name
    shared = (set(rc) & set(pc)) - {k for k in rc if k.endswith(TIMED)}
    assert {k: pc[k] for k in shared} == {k: rc[k] for k in shared}
    tenants = {k: v for k, v in pc.items() if k.startswith("tenant.")
               and not k.endswith(TIMED)}
    assert tenants == {k: v for k, v in rc.items() if k.startswith("tenant.")
                       and not k.endswith(TIMED)}
    assert tenants["tenant.acme.prompt_tokens"] == 9 + 10
    assert tenants["tenant.acme.generated_tokens"] == 5 + 4
    assert tenants["tenant.globex.generated_tokens"] == 6
    assert {k.split(".")[1] for k in pc if k.startswith("tenant.")} == \
        {"acme", "globex", "initech"}
    assert pc["tenant.acme.queue_wait_s"] > 0


def test_rejections_are_accounted_per_tenant(models):
    """A full queue's 429 counts ``serving.rejected`` and the tenant's
    ``rejected``, as the reference's queue does."""
    _, _, tmodel, tp = models
    engine = InferenceEngine(tmodel, tp, cfg=ServingConfig(max_queue=1),
                             device=CPU)
    engine.submit([1, 2], 2, tenant="acme")
    with pytest.raises(QueueFull):
        engine.submit([1, 2], 2, tenant="acme")
    c = tobs.METRICS.snapshot()["counters"]
    assert c["serving.rejected"] == 1 and c["tenant.acme.rejected"] == 1
    engine.stop()


def _traced(server_cls, client_cls, obs, engine):
    """Serve each request over HTTP inside a client span; the span names
    recorded under each request's trace id."""
    out = []
    with server_cls(engine=engine) as server:
        client = client_cls(port=server.port, timeout_s=60.0)
        for p, n, t in REQUESTS:
            with obs.trace.span("client.generate") as sp:
                client.generate(p, n, tenant=t)
            out.append(sp.trace_id)
    events = obs.TRACER.to_chrome_trace()["traceEvents"]
    return [sorted(ev["name"] for ev in events
                   if (ev.get("args") or {}).get("trace_id") == tid)
            for tid in out]


def test_the_same_spans_under_one_trace_id(models):
    jmodel, jp, tmodel, tp = models
    jobs.TRACER.clear()
    jengine = jeng.InferenceEngine(jmodel, params=jp,
                                   cfg=jeng.ServingConfig(**COMMON))
    jengine.start(warmup=False)
    want = _traced(JModelServer, JServingClient, jobs, jengine)
    jengine.stop()
    engine = InferenceEngine(tmodel, tp, cfg=ServingConfig(**COMMON),
                             device=CPU)
    engine.start()
    got = _traced(ModelServer, ServingClient, tobs, engine)
    engine.stop()
    assert got == want
    assert got[0] == sorted(["client.generate", "serving.queue_wait",
                             "serving.prefill", "serving.emit",
                             "serving.request"]
                            + ["serving.decode.segment"] * 3)


def test_server_binds_traceparent_and_answers_injected_faults(models):
    """An inbound ``traceparent`` becomes the request's trace; a
    ``serving.request`` chaos fire answers 503."""
    from deeplearning4j_tpu_torch.resilience import FaultSpec, inject_faults

    _, _, tmodel, tp = models
    engine = InferenceEngine(tmodel, tp, cfg=ServingConfig(slots=2),
                             device=CPU)
    with engine, ModelServer(engine=engine) as server:
        client = ServingClient(port=server.port)
        tid, sid = "ab" * 16, "cd" * 8
        with tobs.trace.bind(tid, sid):
            client.generate([1, 2, 3], 3)
        roots = [ev for ev in tobs.TRACER.to_chrome_trace()["traceEvents"]
                 if ev["name"] == "serving.request"]
        assert [ev["args"]["trace_id"] for ev in roots] == [tid]
        assert roots[0]["args"]["parent_span_id"] == sid
        with inject_faults(FaultSpec("serving.request", probability=1.0)):
            with pytest.raises(ServingError) as ei:
                client.generate([1, 2, 3], 3)
        assert ei.value.status == 503


def test_model_server_captures_completed_generations(models):
    """``ModelServer(capture=...)`` receives every completed generation
    with the raw tenant and its weight generation; a rejected request
    leaves no record."""
    _, _, tmodel, tp = models
    records = []
    engine = InferenceEngine(tmodel, tp, cfg=ServingConfig(slots=2),
                             device=CPU)
    with engine, ModelServer(engine=engine, capture=records) as server:
        client = ServingClient(port=server.port)
        out = client.generate([4, 5, 6], 3, tenant="acme")
        with pytest.raises(ServingError):
            client.generate([999], 3)
    assert records == [{"prompt": [4, 5, 6], "tokens": out["tokens"],
                        "finish_reason": "length", "feedback": None,
                        "tenant": "acme", "generation": 0,
                        "loaded_step": None, "seed": 0,
                        "temperature": 0.0}]
