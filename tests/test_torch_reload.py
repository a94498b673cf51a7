"""Serving from checkpoints and hot reload, in the port and the reference.

An engine opened on a checkpoint directory the reference wrote serves the
reference engine's greedy tokens, before and after both reload the next
step.  The staged swap waits for every slot to be free while admission
pauses, so an in-flight request completes under the old weights and a
request queued behind the reload decodes wholly under the new ones — each
completion's ``generation``/``loaded_step`` stamp names the weights its
tokens came from.  A reload drops the prefix cache, ``POST /v1/reload``
answers 200 or 409, and the whole slice runs in miniature: a supervised
trainer publishes checkpoints that an engine serves and reloads.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.parallel import checkpoint as jck
from deeplearning4j_tpu.serving import engine as jeng
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.optimize import transforms as TT
from deeplearning4j_tpu_torch.parallel import (CheckpointManager,
                                               DataParallelTrainer)
from deeplearning4j_tpu_torch.resilience import (FaultSpec, RetryPolicy,
                                                 TrainingSupervisor,
                                                 corrupt_file, inject_faults)
from deeplearning4j_tpu_torch.serving import (InferenceEngine, ModelServer,
                                              ServingClient, ServingConfig)
from deeplearning4j_tpu_torch.serving.client import ServingError
from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"
KW = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=32)
PROMPTS = [[3, 14, 15], [9, 2, 6, 5, 35], [8], [27, 18, 28, 18, 28, 45, 9]]
NEW = [7, 5, 9, 4]


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **KW)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **KW)
    jps = [jtr.init_params(jax.random.key(k), jcfg) for k in (3, 7)]
    return jtr.TransformerLM(jcfg), jps, ttr.TransformerLM(tcfg, device=CPU)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _expected(tmodel, params, prompt, n):
    return tmodel.sample(params, prompt, n, temperature=0.0,
                         kv_cache=True)[len(prompt):]


def _serve(engine):
    handles = [engine.submit(p, n) for p, n in zip(PROMPTS, NEW)]
    return [h.result(timeout=120) for h in handles]


@pytest.mark.parametrize("kv_quant,impl", [(None, "pallas"),
                                           ("int8", "pallas_int8")])
def test_engine_serves_and_reloads_a_reference_checkpoint(
        tmp_path, models, kv_quant, impl):
    jmodel, (jp1, jp2), tmodel = models
    jmgr = jck.CheckpointManager(tmp_path, keep=5)
    jmgr.save(1, jp1)
    common = dict(slots=4, paged=True, page_size=4, int8_decode=True,
                  paged_attention_impl=impl, kv_quant=kv_quant,
                  min_prefill_bucket=32, resolve_every=3)
    jengine = jeng.InferenceEngine(jmodel, checkpoint=str(tmp_path),
                                   cfg=jeng.ServingConfig(**common))
    engine = InferenceEngine(tmodel, checkpoint=str(tmp_path),
                             cfg=ServingConfig(**common), device=CPU)
    assert engine.stats()["loaded_step"] == 1
    assert engine.stats()["generation"] == 0
    with jengine.start(warmup=False), engine:
        want = [c.tokens for c in _serve(jengine)]
        got = _serve(engine)
        assert [c.tokens for c in got] == want
        assert {(c.generation, c.loaded_step) for c in got} == {(0, 1)}
        jmgr.save(2, jp2)
        assert engine.reload() == jengine.reload() == 2
        want = [c.tokens for c in _serve(jengine)]
        got = _serve(engine)
        assert [c.tokens for c in got] == want
        assert {(c.generation, c.loaded_step) for c in got} == {(1, 2)}
    snap = engine.metrics.snapshot()
    assert snap["counters"]["serving.reloads"] == 1
    assert snap["gauges"]["serving.loaded_step"] == 2
    assert snap["gauges"]["serving.generation"] == 1
    assert "serving.reload" in snap["timers"]
    assert engine.reload() == 2                  # same step: no-op
    assert engine.metrics.snapshot()["counters"]["serving.reloads"] == 1


def test_staged_swap_waits_for_free_slots(tmp_path, models):
    """A reload while a request decodes is staged: admission pauses, the
    in-flight request finishes under step 1, and a request submitted
    after the reload waits for the swap and decodes under step 2 — even
    with a free slot beside the busy one."""
    _, (jp1, jp2), tmodel = models
    p1, p2 = (params_from_numpy(_numpy(p), CPU) for p in (jp1, jp2))
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(1, p1)
    engine = InferenceEngine(tmodel, checkpoint=mgr,
                             cfg=ServingConfig(slots=2, resolve_every=2),
                             device=CPU)
    gate, entered = threading.Event(), threading.Event()
    real = engine._decode_segment

    def gated():
        entered.set()
        assert gate.wait(timeout=60)
        return real()

    engine._decode_segment = gated
    with engine:
        first = engine.submit(PROMPTS[0], 12)
        assert entered.wait(timeout=60)          # admitted, decoding
        mgr.save(2, p2)
        assert engine.reload() == 2
        st = engine.stats()
        assert st["reload_staged"] and st["generation"] == 0
        assert st["loaded_step"] == 1 and st["free"] == 1
        second = engine.submit(PROMPTS[1], 6)
        gate.set()
        a, b = first.result(timeout=120), second.result(timeout=120)
    assert (a.generation, a.loaded_step) == (0, 1)
    assert (b.generation, b.loaded_step) == (1, 2)
    assert a.tokens == _expected(tmodel, p1, PROMPTS[0], 12)
    assert b.tokens == _expected(tmodel, p2, PROMPTS[1], 6)
    assert a.tokens != _expected(tmodel, p2, PROMPTS[0], 12)
    st = engine.stats()
    assert not st["reload_staged"] and st["generation"] == 1


def test_reload_invalidates_the_prefix_cache(tmp_path, models):
    """Cached chains hold K/V of the old weights: a reload drops them, the
    pages they pinned are wiped and freed, and shared-prefix traffic after
    it equals the new params' offline tokens."""
    _, (jp1, jp2), tmodel = models
    p1, p2 = (params_from_numpy(_numpy(p), CPU) for p in (jp1, jp2))
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, p1)
    sys_prompt = [9, 8, 7, 6, 5, 4, 3, 2, 1]           # 2 full pages at ps=4
    prompts = [sys_prompt + [t] for t in (1, 2)]
    engine = InferenceEngine(
        tmodel, checkpoint=str(tmp_path),
        cfg=ServingConfig(slots=2, resolve_every=2, paged=True, page_size=4,
                          prefix_cache=True), device=CPU)
    with engine:
        got = [engine.generate(p, 4).tokens for p in prompts]
        assert got == [_expected(tmodel, p1, p, 4) for p in prompts]
        assert engine.stats()["prefix_entries"] > 0
        assert engine.stats()["prefix_hits"] >= 1
        pinned = engine._pool.in_use()
        assert pinned > 0
        mgr.save(2, p2)
        assert engine.reload() == 2
        assert engine.stats()["prefix_entries"] == 0
        got = [engine.generate(p, 4).tokens for p in prompts]
        assert got == [_expected(tmodel, p2, p, 4) for p in prompts]
        assert engine.stats()["prefix_entries"] > 0    # re-learned
    # nothing leaked: every page in use is a (new-weights) cache pin
    assert engine._pool.free_count() == \
        engine._pool.num_pages - engine._pool.in_use()
    assert not engine._pending_wipe


def test_v1_reload_answers_200_and_409(tmp_path, models):
    _, (jp1, jp2), tmodel = models
    p1, p2 = (params_from_numpy(_numpy(p), CPU) for p in (jp1, jp2))
    mgr = CheckpointManager(tmp_path / "ck", keep=3)
    mgr.save(1, p1)
    engine = InferenceEngine(tmodel, checkpoint=str(tmp_path / "ck"),
                             cfg=ServingConfig(slots=2), device=CPU)
    plain = InferenceEngine(tmodel, p1, cfg=ServingConfig(slots=2),
                            device=CPU)
    with engine, ModelServer(engine) as server, \
            ModelServer(plain) as plain_server:
        client = ServingClient(port=server.port, timeout_s=60)
        out = client.generate([5, 6, 7], max_new_tokens=3)
        assert (out["generation"], out["loaded_step"]) == (0, 1)
        mgr.save(2, p2)
        assert client.reload() == 2
        out = client.generate([5, 6, 7], max_new_tokens=3)
        assert (out["generation"], out["loaded_step"]) == (1, 2)
        assert out["tokens"] == _expected(tmodel, p2, [5, 6, 7], 3)
        assert client.reload(step=1) == 1            # an explicit step
        assert client.healthz()["engine"]["loaded_step"] == 1
        with pytest.raises(ServingError) as e:       # no checkpoint: 409
            ServingClient(port=plain_server.port).reload()
        assert e.value.status == 409
        for s in mgr.all_steps():                    # nothing verifies: 409
            corrupt_file(tmp_path / "ck" / f"ckpt_{s:010d}" / "params.npz",
                         "truncate")
        with pytest.raises(ServingError) as e:
            client.reload()
        assert e.value.status == 409


def test_engine_checkpoint_open_errors(tmp_path, models):
    _, _, tmodel = models
    with pytest.raises(ValueError, match="params or a checkpoint"):
        InferenceEngine(tmodel, cfg=ServingConfig(), device=CPU)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no verified checkpoint"):
        InferenceEngine(tmodel, checkpoint=str(tmp_path / "empty"),
                        device=CPU)
    with pytest.raises(RuntimeError, match="nothing to reload"):
        InferenceEngine(tmodel, tmodel.init(), device=CPU).reload()
    # the directory is opened read-only: the engine cannot write it
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, tmodel.init())
    engine = InferenceEngine(tmodel, checkpoint=str(tmp_path / "ck"),
                             device=CPU)
    assert engine._ckpt.read_only


def test_trainer_publishes_and_the_engine_reloads(tmp_path, models):
    """The slice in miniature: a supervised trainer (with a step fault)
    publishes checkpoints of the LM, an engine serves the newest valid
    one, two more steps publish another, and a reload serves it — each
    completion equal to the offline tokens of its stamped step."""
    _, (jp1, _), tmodel = models
    tcfg = tmodel.cfg
    rng = np.random.default_rng(9)
    data = []
    for _ in range(6):
        toks = rng.integers(0, KW["vocab_size"], (2, 16)).astype(np.int64)
        data.append((toks, np.roll(toks, -1, axis=1)))
    trainer = DataParallelTrainer(
        lambda p, x, y, g=None: ttr.lm_loss_local(p, x, y, tcfg),
        TT.adamw(TT.warmup_cosine(3e-2, 1, 100)), device=CPU)
    params = params_from_numpy(_numpy(jp1), CPU)
    mgr = CheckpointManager(tmp_path, keep=2)
    with inject_faults(FaultSpec("train.step", at_step=3)):
        sup = TrainingSupervisor(mgr, RetryPolicy(backoff_base_s=0.0))
        state, _ = sup.fit(trainer, params, data[:4], checkpoint_every=2)
    assert sup.report.retries == 1 and mgr.all_steps() == [2, 4]
    engine = InferenceEngine(tmodel, checkpoint=str(tmp_path),
                             cfg=ServingConfig(slots=2, paged=True,
                                               page_size=4), device=CPU)
    with engine:
        a = engine.generate(PROMPTS[3], 6)
        # the stream's cursor is the step: steps 5 and 6 take data[4:]
        state, _ = trainer.fit(state, data, checkpoint_manager=mgr,
                               resume=False)
        assert mgr.latest_valid_step() == 6
        assert engine.reload() == 6
        b = engine.generate(PROMPTS[3], 6)
    assert (a.loaded_step, b.loaded_step) == (4, 6)
    p4 = mgr.restore(params, step=4)
    assert a.tokens == _expected(tmodel, p4["params"], PROMPTS[3], 6)
    assert b.tokens == _expected(tmodel, state.params, PROMPTS[3], 6)
