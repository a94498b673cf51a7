"""``BatchScorer``, ``ScoreRequest`` and ``/v1/score``: coalescing into
power-of-two buckets, parity with direct calls, and the HTTP round trip
through ``ModelServer(scorer=...)`` and ``ServingClient.score``.

The forward case scores rows of token ids through the port's
``forward_local`` on a small model (2 layers, d_model 64, 4 heads, vocab
97) in float32 on the CPU, against the JAX package's ``forward_local`` on
the same parameters (through numpy), within 1e-5.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.serving import (BatchScorer, InferenceEngine,
                                              ModelServer, QueueFull,
                                              ScoreRequest, ServingClient,
                                              ServingConfig, ServingError)
from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"
KW = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
          max_len=16)


def test_batch_scorer_coalesces_and_matches_direct():
    calls = []
    w = np.arange(12, dtype=np.float32).reshape(4, 3)

    def fn(xs):
        calls.append(np.asarray(xs).shape[0])
        return np.asarray(xs) @ w

    xs = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    with BatchScorer(fn, max_batch=8) as sc:
        np.testing.assert_allclose(sc.score_batch(xs), xs @ w, rtol=1e-6)
        np.testing.assert_allclose(sc.score(xs[0]), xs[0] @ w, rtol=1e-6)
        with pytest.raises(ValueError, match="row shape"):
            sc.submit(np.zeros((5,), np.float32))
    assert calls and all(c & (c - 1) == 0 for c in calls)  # pow2 buckets only
    counters = tobs.METRICS.snapshot()["counters"]
    assert counters["serving.score.rows"] == 7
    assert counters["serving.score.recompile"] == len(set(calls))


def test_batch_scorer_coalesces_concurrent_callers():
    """Rows of concurrent callers share batches (never more than
    ``max_batch`` rows, padded by repeating the first row), every caller
    gets its own rows back, and a failing ``fn`` fails its batch only."""
    seen = []

    def fn(xs):
        xs = np.asarray(xs)
        seen.append(xs.shape[0])
        if np.any(xs[:, 0] < 0):
            raise RuntimeError("negative row")
        return xs * 2

    out = {}
    with BatchScorer(fn, max_batch=4, max_batch_delay_ms=20) as sc:
        def caller(i):
            out[i] = sc.score_batch(np.full((3, 2), i, np.float32))
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(1, 5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        with pytest.raises(RuntimeError, match="negative"):
            sc.score(np.array([-1.0, 0.0], np.float32))
        np.testing.assert_array_equal(sc.score(np.ones(2, np.float32)),
                                      [2.0, 2.0])
    for i in range(1, 5):
        np.testing.assert_array_equal(out[i], np.full((3, 2), 2.0 * i))
    assert max(seen) <= 4 and all(c & (c - 1) == 0 for c in seen)
    assert tobs.METRICS.snapshot()["counters"]["serving.score.errors"] == 1


def test_score_request_queues_and_bounds():
    with BatchScorer(lambda xs: xs, max_queue=1) as sc:
        sc.stop()                     # no worker: the queue fills
        assert isinstance(sc.submit(np.zeros(2)).request, ScoreRequest)
        with pytest.raises(QueueFull):
            sc.submit(np.zeros(2))


@pytest.fixture(scope="module")
def lm():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **KW)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **KW)
    jp = jtr.init_params(jax.random.key(11), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    return jcfg, jp, tcfg, tp


def test_forward_scorer_rows_match_direct_calls_and_jax(lm):
    """A scorer over ``forward_local`` (rows of token ids in, per-token
    log-probabilities of the row's own tokens out) equals one direct
    call per row and the JAX package's forward."""
    jcfg, jp, tcfg, tp = lm

    def logp(logits, toks):
        lp = torch.log_softmax(torch.as_tensor(np.array(logits)), -1)
        return lp.gather(-1, torch.as_tensor(toks)[..., None])[..., 0]

    def fn(xs):
        toks = torch.as_tensor(xs).long()
        return logp(ttr.forward_local(tp, toks, tcfg), toks)

    rows = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (5, jcfg.max_len)).astype(np.float32)
    with BatchScorer(fn, max_batch=8) as sc:
        served = sc.score_batch(rows)
    for row, got in zip(rows, served):
        toks = row[None].astype(np.int64)
        direct = fn(row[None])[0].numpy()
        jlog = jtr.forward_local(jp, jnp.asarray(toks, jnp.int32), jcfg)
        np.testing.assert_allclose(got, direct, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, logp(jlog, toks)[0].numpy(),
                                   atol=1e-5, rtol=0)


def test_model_server_scores_over_http(lm):
    """``/v1/score`` through ``ServingClient.score``: a scorer-only server
    answers it and refuses ``/v1/generate`` (400); a server with both
    serves both, ``tenant`` riding the generate call."""
    _, _, tcfg, tp = lm
    w = np.arange(8, dtype=np.float32).reshape(4, 2)
    rows = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    with BatchScorer(lambda xs: np.asarray(xs) @ w, max_batch=4) as sc, \
            ModelServer(scorer=sc) as server:
        client = ServingClient(port=server.port, timeout_s=60)
        np.testing.assert_allclose(np.asarray(client.score(rows)), rows @ w,
                                   rtol=1e-5)
        with pytest.raises(ServingError) as e:
            client.generate([1, 2], max_new_tokens=2)
        assert e.value.status == 400
        health = client.healthz()
        assert health["ok"] and "engine" not in health
        assert health["scorer"]["queue_depth"] == 0
        assert client.metrics()["counters"]["serving.score.rows"] == 3
    model = ttr.TransformerLM(tcfg, device=CPU)
    engine = InferenceEngine(model, tp, cfg=ServingConfig(slots=2),
                             device=CPU)
    with engine, BatchScorer(lambda xs: np.asarray(xs) @ w) as sc, \
            ModelServer(engine=engine, scorer=sc) as server:
        client = ServingClient(port=server.port, timeout_s=60)
        out = client.generate([5, 6, 7], max_new_tokens=3, tenant="acme")
        assert out["tokens"] == model.sample(tp, [5, 6, 7], 3,
                                             temperature=0.0)[3:]
        np.testing.assert_allclose(np.asarray(client.score(rows[:1])),
                                   rows[:1] @ w, rtol=1e-5)
        with pytest.raises(ServingError) as e:
            client.score([])
        assert e.value.status == 400
