"""Speculative decoding and the prefix cache: the port's engine against the
JAX package's, and the page pool's prefix bookkeeping.

Both engines get the same parameters (through numpy), the same
``ServingConfig`` and the same requests, in float32 on the CPU, on a small
model (2 layers, d_model 64, 4 heads, vocab 97); greedy served tokens must
be identical.  Sampled requests are held to the port's own offline
sampler.  The ``PagePool`` cases mirror the JAX package's
``tests/test_serving_paged.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.serving import engine as jeng
from deeplearning4j_tpu.serving import paging as jpaging
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.serving import (InferenceEngine, PagePool,
                                              PagePoolExhausted, QueueFull,
                                              ServingConfig,
                                              prefix_chain_keys)
from torch_sync_guard import NoHostSync
from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"
KW = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
          max_len=32)
GREEDY = [([5, 1, 4], 6), ([2, 8, 2, 8, 2, 8, 2, 8, 2], 4), ([7], 5),
          ([3, 2, 1, 0, 5], 6), ([40, 41, 42, 43, 44, 45], 7)]
SYS = [9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 11, 12]          # 3 pages at ps=4
SHARED = [(SYS + [t], n) for t, n in ((1, 5), (2, 6), (3, 4), (4, 5))]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, remat=False, **KW)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, remat=False, **KW)
    jp = jtr.init_params(jax.random.key(7), jcfg)
    tp = params_from_numpy(_np(jp), CPU)
    jdraft, jdp = jzoo.draft_lm(jcfg, seed=99)          # a bad draft
    tdraft, _ = tzoo.draft_lm(tcfg, device=CPU)
    assert (tdraft.cfg.d_model, tdraft.cfg.n_heads, tdraft.cfg.n_layers,
            tdraft.cfg.d_ff) == (jdraft.cfg.d_model, jdraft.cfg.n_heads,
                                 jdraft.cfg.n_layers, jdraft.cfg.d_ff)
    return {"jmodel": jtr.TransformerLM(jcfg), "jp": jp,
            "tmodel": ttr.TransformerLM(tcfg, device=CPU), "tp": tp,
            "jdraft": jdraft, "jdp": jdp,
            "tdraft": tdraft, "tdp": params_from_numpy(_np(jdp), CPU)}


def _jax_serve(m, plans, scfg, draft=False):
    kw = dict(draft_model=m["jdraft"], draft_params=m["jdp"]) if draft \
        else {}
    engine = jeng.InferenceEngine(m["jmodel"], params=m["jp"], cfg=scfg,
                                  **kw)
    handles = [engine.submit(p, n) for p, n in plans]
    with engine.start(warmup=False):
        return [h.result(300).tokens for h in handles]


def _serve(m, plans, scfg, draft="bad", temps=None):
    """The port's engine over ``plans``; ``draft`` is "bad" (the random
    draft), "self" (the target drafts for itself) or None."""
    kw = {}
    if draft == "bad":
        kw = dict(draft_model=m["tdraft"], draft_params=m["tdp"])
    elif draft == "self":
        kw = dict(draft_model=m["tmodel"], draft_params=m["tp"])
    engine = InferenceEngine(m["tmodel"], m["tp"], cfg=scfg, device=CPU,
                             **kw)
    temps = temps or [(0.0, 0)] * len(plans)
    with engine:
        handles = [engine.submit(p, n, temperature=t, seed=s)
                   for (p, n), (t, s) in zip(plans, temps)]
        got = [h.result(timeout=300).tokens for h in handles]
    return engine, got


def _accept():
    """``serving.spec_accept_len`` of the process-wide registry (the
    engines of a test publish to it in turn: read it between them)."""
    return tobs.METRICS.snapshot()["timers"]["serving.spec_accept_len"]


# ------------------------------------------------------------ PagePool

def test_prefix_chain_keys_equal_the_reference():
    toks = list(range(3, 40))
    for usable, ps in ((36, 4), (12, 5), (3, 4)):
        assert prefix_chain_keys(toks, usable, ps) == \
            jpaging.prefix_chain_keys(toks, usable, ps)


def test_prefix_refcounts_never_free_aliased_pages():
    """An aliased page is freed only when its last reader lets go; cache
    eviction drops the pin, never the page."""
    pool = PagePool(num_pages=8, page_size=2)
    prompt = [1, 2, 3, 4, 5]             # 2 full pages usable (len-1 == 4)
    a = pool.alloc(3)
    pool.insert_prefix(prompt, a, usable=4)   # pins a[0], a[1]
    assert pool.prefix_entries() == 2    # chains of length 1 and 2
    shared, cached = pool.lookup_prefix(prompt, usable=4)
    assert shared == a[:2] and cached == 4
    assert pool.refcount(a[0]) == 4      # A + both chain pins + B
    assert pool.decref(a) == [a[2]]      # only the unshared tail page
    grabbed = pool.alloc(6)              # exactly the free pages
    assert pool.prefix_entries() == 2
    assert not set(shared) & set(grabbed), "aliased page handed out twice"
    with pytest.raises(PagePoolExhausted):
        pool.alloc(1)                    # evicts both chains, still short
    assert pool.prefix_entries() == 0
    assert pool.refcount(a[0]) == 1      # B still reading, page intact
    assert sorted(pool.decref(shared)) == sorted(shared)
    pool.decref(grabbed)
    assert pool.free_count() == pool.num_pages
    assert pool.refcounts() == [0] * pool.num_pages
    assert pool.hit_counts() == (1, 1) and pool.hit_rate() == 1.0


def test_prefix_exhaustion_evicts_lru_then_429s():
    pool = PagePool(num_pages=4, page_size=2)
    pages = pool.alloc(2)
    pool.insert_prefix([1, 2, 3, 4, 5], pages, usable=4)
    pool.decref(pages)                   # only the cache pins remain
    assert pool.free_count() == 2
    assert pool.peek_prefix([1, 2, 3, 4, 5], 4) == 4
    pool.alloc(4)                        # evicts the cache to make room
    assert pool.peek_prefix([1, 2, 3, 4, 5], 4) == 0
    with pytest.raises(PagePoolExhausted) as ei:
        pool.alloc(1)
    assert ei.value.status == 429


def test_clear_prefix_quarantines_until_requeue():
    pool = PagePool(num_pages=4, page_size=2)
    a = pool.alloc(2)
    pool.insert_prefix([1, 2, 3, 4, 5], a, usable=4)
    shared, cached = pool.lookup_prefix([1, 2, 3, 4, 5], usable=4)
    assert shared == a and cached == 4
    pool.decref(a)                       # original slot done; alias remains
    assert pool.clear_prefix() == [] and pool.prefix_entries() == 0
    assert pool.refcount(a[0]) == 1      # the alias keeps the page alive
    pool.decref(shared)                  # last reader: frees normally
    assert pool.free_count() == pool.num_pages
    b = pool.alloc(2)
    pool.insert_prefix([7, 7, 7, 7, 7], b, usable=4)
    pool.decref(b)                       # only the cache pins remain
    dead = pool.clear_prefix()
    assert sorted(dead) == sorted(b)
    assert pool.free_count() == 2        # quarantined pages not handed out
    with pytest.raises(PagePoolExhausted):
        pool.alloc(3)
    pool.requeue(dead)
    assert pool.free_count() == pool.num_pages
    c = pool.alloc(1)
    assert pool.decref_quarantine(c) == c and pool.free_count() == 3


# ------------------------------------------------------------ engines

@pytest.mark.parametrize("paged", [False, True])
def test_speculative_greedy_tokens_equal_the_reference(models, paged):
    """A bad draft (random parameters) serves the reference's tokens; a
    self-draft serves the same tokens with longer accepted windows."""
    common = dict(slots=3, resolve_every=2, speculative=True, spec_k=3,
                  min_prefill_bucket=32)
    if paged:
        common.update(paged=True, page_size=4)
    want = _jax_serve(models, GREEDY, jeng.ServingConfig(**common),
                      draft=True)
    bad, got = _serve(models, GREEDY, ServingConfig(**common))
    assert got == want
    assert [len(t) for t in got] == [n for _, n in GREEDY]
    n_bad = _accept()["count"]
    good, got_self = _serve(models, GREEDY, ServingConfig(**common),
                            draft="self")
    assert got_self == want
    n_good = _accept()["count"] - n_bad
    assert n_bad > 0 and n_good > 0
    # a self-draft agrees with every pick: most windows emit spec_k + 1
    assert n_good < n_bad
    assert bad.stats()["completed"] == len(GREEDY)
    if paged:
        assert bad.stats()["kv_pages_in_use"] == 0


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_prefix_cache_greedy_tokens_equal_the_reference(models, kv_quant):
    """Requests sharing a 3-page system prompt: the same tokens as the
    JAX package's prefix-cache engine and as the port without the cache,
    a positive hit rate, and nothing leaked after the drain."""
    common = dict(slots=2, resolve_every=2, paged=True, page_size=4,
                  prefix_cache=True, min_prefill_bucket=32,
                  kv_quant=kv_quant)
    want = _jax_serve(models, SHARED, jeng.ServingConfig(**common))
    engine, got = _serve(models, SHARED, ServingConfig(**common),
                         draft=None)
    assert got == want
    _, plain = _serve(models, SHARED, ServingConfig(
        **dict(common, prefix_cache=False)), draft=None)
    if kv_quant is None:
        assert plain == got
    stats = engine.stats()
    assert stats["prefix_hit_rate"] > 0 and stats["prefix_entries"] > 0
    assert stats["prefix_hits"] >= 1
    assert tobs.METRICS.snapshot()["counters"]["serving.prefix_hits"] >= 1
    pinned = engine._pool.in_use()       # only cache pins remain
    assert engine._pool.free_count() == engine._pool.num_pages - pinned
    assert sum(engine._pool.refcounts()) == sum(
        len(e.pages) for e in engine._pool._prefix.values())


def test_prefix_and_speculative_together_equal_the_reference(models):
    common = dict(slots=3, resolve_every=2, paged=True, page_size=5,
                  prefix_cache=True, speculative=True, spec_k=2,
                  min_prefill_bucket=32)
    plans = SHARED + GREEDY[:2]
    want = _jax_serve(models, plans, jeng.ServingConfig(**common),
                      draft=True)
    engine, got = _serve(models, plans, ServingConfig(**common))
    assert got == want
    assert engine.stats()["prefix_hit_rate"] > 0


@pytest.mark.parametrize("paged,spec_k", [(False, 3), (True, 2)])
def test_sampled_speculative_tokens_equal_offline_sample(models, paged,
                                                         spec_k):
    """Sampled requests through the noise ring: the port's offline
    ``sample`` with the same seed, for good and bad drafts and with
    segments longer than a window."""
    tmodel, tp = models["tmodel"], models["tp"]
    plans = [([4, 5, 6], 9), ([7, 8], 7), ([9, 10, 11, 12], 8), ([3], 6)]
    temps = [(0.8, 21), (1.3, 5), (0.0, 0), (1.0, 77)]
    want = [tmodel.sample(tp, p, n, temperature=t, seed=s)[len(p):]
            for (p, n), (t, s) in zip(plans, temps)]
    scfg = ServingConfig(slots=3, resolve_every=3, speculative=True,
                         spec_k=spec_k, paged=paged, page_size=4)
    for draft in ("bad", "self"):
        _, got = _serve(models, plans, scfg, draft=draft, temps=temps)
        assert got == want, draft


def test_brownout_setters_keep_tokens(models):
    """``set_speculative(False)`` falls back to the plain step with the
    same tokens (sampled ones included); ``set_max_new_cap`` clamps the
    budget to a prefix of the uncapped tokens; an admission hook
    rejects; ``submit`` carries ``tenant`` and ``priority``."""
    tmodel, tp = models["tmodel"], models["tp"]
    engine = InferenceEngine(
        tmodel, tp, cfg=ServingConfig(slots=2, resolve_every=2,
                                      speculative=True, spec_k=2),
        draft_model=models["tdraft"], draft_params=models["tdp"],
        device=CPU)
    plans = [([4, 5, 6], 8, 0.9, 3), ([7, 8], 6, 0.0, 0)]
    want = [tmodel.sample(tp, p, n, temperature=t, seed=s)[len(p):]
            for p, n, t, s in plans]
    with engine:
        assert engine.set_speculative(False) is False
        got = [engine.generate(p, n, temperature=t, seed=s,
                               timeout=300).tokens for p, n, t, s in plans]
        assert got == want
        assert engine.set_speculative(True) is True
        engine.set_max_new_cap(3)
        short = engine.generate([4, 5, 6], 8, temperature=0.9, seed=3,
                                timeout=300)
        assert short.tokens == want[0][:3]
        engine.set_max_new_cap(None)
        h = engine.submit([1, 2], 2, tenant="acme", priority=1)
        assert h.request.tenant == "acme" and h.request.priority == 1
        h.result(timeout=300)

        def reject(req):
            raise QueueFull(f"shed {req.id}")
        engine.set_admission_hook(reject)
        with pytest.raises(QueueFull):
            engine.submit([1, 2], 2)
        engine.set_admission_hook(None)
        stats = engine.stats()
        assert stats["speculative_enabled"] and stats["max_new_cap"] is None
    snap = tobs.METRICS.snapshot()
    assert snap["counters"]["serving.max_new_clamped"] == 1
    assert snap["gauges"]["serving.speculative_enabled"] == 1.0


@pytest.mark.parametrize("kw,exc,match", [
    (dict(speculative=True), ValueError, "draft_model"),
    (dict(prefix_cache=True), ValueError, "paged"),
    (dict(role="prefill"), ValueError, "paged"),
    (dict(paged=True, kv_quant="int4"), ValueError, "kv_quant mode"),
])
def test_engine_checks_its_config(models, kw, exc, match):
    with pytest.raises(exc, match=match):
        InferenceEngine(models["tmodel"], models["tp"],
                        cfg=ServingConfig(**kw), device=CPU)


def test_draft_must_share_vocab_and_max_len(models):
    import dataclasses
    other = ttr.TransformerLM(dataclasses.replace(models["tmodel"].cfg,
                                                  vocab_size=50), device=CPU)
    with pytest.raises(ValueError, match="vocab_size and max_len"):
        InferenceEngine(models["tmodel"], models["tp"],
                        cfg=ServingConfig(speculative=True),
                        draft_model=other, draft_params=models["tp"],
                        device=CPU)
    with pytest.raises(ValueError, match="spec_k"):
        InferenceEngine(models["tmodel"], models["tp"],
                        cfg=ServingConfig(speculative=True, spec_k=0),
                        draft_model=models["tdraft"],
                        draft_params=models["tdp"], device=CPU)


def test_speculative_segment_makes_no_host_sync(models, monkeypatch):
    """The hot-loop rule holds for the speculative step and its noise
    ring: between fences no ``.item()``, ``.cpu()``, ``.tolist()`` or
    ``nonzero``, from Python or from inside ATen (:class:`NoHostSync`:
    a 0-d tensor index is such a read)."""
    engine = InferenceEngine(
        models["tmodel"], models["tp"],
        cfg=ServingConfig(slots=2, paged=True, page_size=4,
                          prefix_cache=True, speculative=True, spec_k=3),
        draft_model=models["tdraft"], draft_params=models["tdp"],
        device=CPU)
    real = engine._decode_segment
    calls = []

    def guarded():
        def boom(*a, **k):
            raise AssertionError("host sync inside the decode segment")
        with monkeypatch.context() as m:
            for name in ("item", "cpu", "tolist", "numpy", "nonzero"):
                m.setattr(torch.Tensor, name, boom)
            with NoHostSync():
                out = real()
        calls.append(len(out))
        return out

    engine._decode_segment = guarded
    with engine:
        toks = engine.generate([1, 2, 3], 9, temperature=0.7, seed=1,
                               timeout=300).tokens
    assert calls and toks == models["tmodel"].sample(
        models["tp"], [1, 2, 3], 9, temperature=0.7, seed=1)[3:]
