"""The disaggregated prefill/decode tier of the port, against the JAX
package's.

The contract is token parity: a request prefilled on a prefill-role
engine, its KV pages migrated into a decode-role engine's pool, and
decoded there emits exactly the tokens a unified engine emits, on float,
int8 and fp8 pages, and greedy tokens equal the JAX package's engines on
the same parameters (through numpy), in float32 on the CPU.  Around it,
the counterparts of the JAX package's ``tests/test_disagg.py``: the
hash-only repeat migration, the chaos-killed prefill worker, migrations
racing decode-side eviction, the prober refusing prefill replicas, and
``/v1/migrate`` over HTTP; and the wire form in both directions between
the packages (a payload either exports imports into the other).
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
from deeplearning4j_tpu.serving.disagg import migrate as jmig
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.resilience import FaultSpec, inject_faults
from deeplearning4j_tpu_torch.serving import (DisaggScheduler,
                                              GenerateRequest,
                                              InferenceEngine, KVMigrator,
                                              MigrationRejected,
                                              ModelServer, PendingResult,
                                              PrefillRecord, ServingClient,
                                              ServingConfig, export_payload)
from deeplearning4j_tpu_torch.serving.router.replicas import (EngineReplica,
                                                              ReplicaPool)
from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"
KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=32, remat=False, xent_chunk=0)
#: page_size 8 and a 9-token prompt: 8 usable positions, exactly one full
#: page, so a second migration can claim every content page by hash
PROMPT = [1, 2, 3, 4, 5, 6, 7, 8, 9]
PAGES = (None, "int8", "fp8")


def _cfgs(**kw):
    kw = {**KW, **kw}
    return (jtr.TransformerConfig(dtype=jnp.float32, **kw),
            ttr.TransformerConfig(dtype=torch.float32, **kw))


def _lm(seed=7, **kw):
    """The same weights in both packages: the JAX package's draw, moved
    through numpy."""
    jcfg, tcfg = _cfgs(**kw)
    jp = jtr.init_params(jax.random.key(seed), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    return (jtr.TransformerLM(jcfg), jp,
            ttr.TransformerLM(tcfg, device=CPU), tp)


def _skw(**skw):
    skw.setdefault("slots", 4)
    skw.setdefault("resolve_every", 4)
    skw.setdefault("paged", True)
    skw.setdefault("page_size", 8)
    skw.setdefault("prefix_cache", True)
    return skw


def mk(model, params, role, draft=(None, None), **skw):
    return InferenceEngine(model, params, cfg=ServingConfig(
        role=role, **_skw(**skw)), draft_model=draft[0],
        draft_params=draft[1], device=CPU)


def mk_ref(model, params, role, **skw):
    return jeng.InferenceEngine(model, params=params, cfg=jeng.ServingConfig(
        role=role, min_prefill_bucket=KW["max_len"], **_skw(**skw)))


def ctr(name):
    return tobs.METRICS.snapshot()["counters"].get(name, 0.0)


@pytest.fixture(scope="module")
def lm():
    # GQA: every fixture test migrates shared-head page layouts
    return _lm(n_kv_heads=2)


@pytest.fixture
def disagg(lm):
    _, _, model, params = lm
    pf, dec = mk(model, params, "prefill"), mk(model, params, "decode")
    sched = DisaggScheduler([pf], dec).start()
    yield sched, pf, dec
    sched.stop()


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("kv_quant", PAGES)
def test_migrated_decode_token_parity(kv_quant):
    """Prefill on one tier, migration, decode on the other: the same
    tokens as a unified engine of the same config (greedy and sampled),
    and greedy tokens equal the JAX package's engine; the content pages
    arrive byte for byte as the prefill engine's pool holds them."""
    jmodel, jp, model, params = _lm()
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]
    reqs = [dict(temperature=0.0, seed=0), dict(temperature=0.6, seed=5)]
    uni = mk(model, params, "unified", kv_quant=kv_quant).start(warmup=False)
    try:
        want = [uni.generate(prompt, 10, timeout=120, **r).tokens
                for r in reqs]
    finally:
        uni.stop()
    ref = mk_ref(jmodel, jp, "unified", kv_quant=kv_quant)
    handle = ref.submit(prompt, 10)
    with ref.start(warmup=False):
        assert handle.result(300).tokens == want[0]
    pf = mk(model, params, "prefill", kv_quant=kv_quant)
    dec = mk(model, params, "decode", kv_quant=kv_quant)
    sched = DisaggScheduler([pf], dec).start()
    try:
        got = [sched.generate(prompt, 10, timeout=120, **r) for r in reqs]
        assert [c.tokens for c in got] == want
        assert all(c.finish_reason == "length" for c in got)
        # both pools pin the prompt's two full pages in their prefix
        # caches: the decode side's are the prefill side's bytes
        keys = pf.page_pool.chain_keys(prompt, len(prompt) - 1)
        src = pf.page_pool._prefix[keys[-1]].pages
        dst = dec.page_pool._prefix[keys[-1]].pages
        for a, b in zip(pf._state["pages"], dec._state["pages"]):
            for name in a:
                assert a[name].dtype == b[name].dtype
                assert torch.equal(
                    a[name][list(src)].view(torch.uint8),
                    b[name][list(dst)].view(torch.uint8))
    finally:
        sched.stop()
    assert ctr("disagg.migrations") == 2
    assert ctr("disagg.pages_moved") == 2          # the second: claims
    assert ctr("disagg.pages_deduped") == 2


def test_migrated_speculative_decode_token_parity():
    """A speculative decode engine rebuilds the migrated row's draft cache
    itself: the same tokens as a unified speculative engine."""
    _, _, model, params = _lm()
    draft = tzoo.draft_lm(model.cfg, device=CPU)
    skw = dict(speculative=True, spec_k=3)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    uni = mk(model, params, "unified", draft, **skw).start(warmup=False)
    try:
        want = uni.generate(prompt, 10, timeout=120).tokens
    finally:
        uni.stop()
    sched = DisaggScheduler([mk(model, params, "prefill", draft, **skw)],
                            mk(model, params, "decode", draft, **skw)).start()
    try:
        assert sched.generate(prompt, 10, timeout=120).tokens == want
    finally:
        sched.stop()
    assert want == model.sample(params, prompt, 10, temperature=0.0,
                                kv_cache=True)[len(prompt):]


# ------------------------------------------------------------------- dedup

def test_repeat_migration_is_hash_only_zero_bytes(lm, disagg):
    """The second migration of an identical prompt finds every content
    page resident on the decode side: hash-only claims, no bytes, the
    same tokens; the per-tier queue gauges and the advisory plan."""
    _, _, model, params = lm
    sched, pf, dec = disagg
    want = model.sample(params, PROMPT, 12, temperature=0.0,
                        kv_cache=True)[len(PROMPT):]
    c0 = sched.generate(PROMPT, 12, timeout=120)
    assert c0.tokens == want
    m0 = (ctr("disagg.pages_moved"), ctr("disagg.pages_deduped"),
          ctr("disagg.bytes_moved"))
    assert ctr("disagg.migrations") == 1 and m0[0] == 1 and m0[2] > 0
    c1 = sched.generate(PROMPT, 12, timeout=120)
    m1 = (ctr("disagg.pages_moved"), ctr("disagg.pages_deduped"),
          ctr("disagg.bytes_moved"))
    assert c1.tokens == want
    assert m1[0] - m0[0] == 0, "re-migrated prompt moved page bytes"
    assert m1[2] - m0[2] == 0
    assert m1[1] - m0[1] == 1, "resident content page was not claimed"
    plan = KVMigrator(dec).plan_transfer(PROMPT, 12)
    assert plan.pages_moved == 0 and plan.pages_deduped == 1
    assert [e.action for e in plan.entries] == ["claim", "alloc", "alloc"]
    gauges = tobs.METRICS.snapshot()["gauges"]
    assert "serving.queue.depth.prefill" in gauges
    assert "serving.queue.depth.decode" in gauges
    assert pf.stats()["role"] == "prefill"
    assert sched.stats()["role"] == "disagg"
    assert not pf.stats()["running"]


# ------------------------------------------------------------------- chaos

def test_chaos_killed_prefill_worker_requeues_without_corruption():
    """A worker killed before its prefill, one killed holding a prefill
    record, and a migration aborted mid-transfer each requeue the request:
    the same tokens as the undisturbed run, and afterwards both pools'
    references balance to zero leaked pages."""
    _, _, model, params = _lm()
    pf, dec = mk(model, params, "prefill"), mk(model, params, "decode")
    sched = DisaggScheduler([pf], dec).start()
    try:
        prompt = [2, 3, 4, 5, 6]
        base = sched.generate(prompt, 8, timeout=120)
        assert base.tokens == model.sample(params, prompt, 8,
                                           temperature=0.0,
                                           kv_cache=True)[len(prompt):]
        r0 = ctr("disagg.requeues")
        with inject_faults(FaultSpec("disagg.prefill_worker", at_step=1,
                                     max_fires=1), seed=11):
            c1 = sched.generate(prompt, 8, timeout=120)
        with inject_faults(FaultSpec("disagg.prefill_worker", at_step=2,
                                     max_fires=1), seed=11):
            c2 = sched.generate(prompt, 8, timeout=120)
        with inject_faults(FaultSpec("disagg.migrate", at_step=2,
                                     max_fires=1), seed=12):
            c3 = sched.generate(prompt, 8, timeout=120)
        assert c1.tokens == c2.tokens == c3.tokens == base.tokens
        assert ctr("disagg.requeues") - r0 >= 3
        # zero-leak audit: drop the prefix-cache pins (the only references
        # left) and every page comes back (no wipe needed: these pools
        # serve nothing more)
        time.sleep(0.3)
        for pool in (pf.page_pool, dec.page_pool):
            pool.requeue(pool.clear_prefix())
            assert pool.free_count() == pool.num_pages
            assert sum(pool.refcounts()) == 0
    finally:
        sched.stop()


def test_release_prefill_and_rejected_migration_leak_nothing(lm):
    """A prefill record released without migrating frees its pages; a
    migration whose generation moved before admission is rejected with
    its decode-side pages released, and the handle stays open."""
    _, _, model, params = lm
    pf = mk(model, params, "prefill", prefix_cache=False)
    rec = pf.prefill([5, 6, 7, 8, 9, 10], 4)
    assert isinstance(rec, PrefillRecord) and rec.pages
    assert pf.page_pool.in_use() == len(rec.pages)
    pf.release_prefill(rec)
    assert pf.page_pool.in_use() == 0 and rec.pages == []
    dec = mk(model, params, "decode", prefix_cache=False).start(warmup=False)
    try:
        pending = PendingResult(GenerateRequest([5, 6, 7, 8, 9, 10], 4))
        # a claim planned under a generation the engine no longer serves
        ticket = dec.admit_from_pages(
            pending, pages=dec.page_pool.alloc(2), uploads=[],
            generation=dec.stats()["generation"] + 1)
        assert ticket.wait(30) is False
        assert "generation" in ticket.reason and not pending.done()
        assert dec.page_pool.in_use() == 0
        with pytest.raises(ValueError, match="page count"):
            dec.admit_from_pages(pending, pages=[0], uploads=[])
    finally:
        dec.stop()


# ------------------------------------------------------- concurrent evict

def test_concurrent_migrate_and_evict_keep_parity(lm, disagg):
    """Migrations racing decode-side prefix eviction: an eviction between
    a plan and its claim turns claims into byte moves, never corrupts
    tokens and never deadlocks."""
    _, _, model, params = lm
    sched, _pf, dec = disagg
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5], [2, 7, 1, 8, 2, 8],
               [1, 6, 1, 8, 0, 3, 3], [4, 4, 7, 2, 13, 5, 30]]
    want = [model.sample(params, p, 8, temperature=0.0,
                         kv_cache=True)[len(p):] for p in prompts]
    stop = threading.Event()

    def evictor():
        while not stop.is_set():
            dec.queue_wipe(dec.page_pool.clear_prefix())
            time.sleep(0.01)

    results = {}

    def worker(i):
        for _ in range(2):
            results[i] = sched.generate(prompts[i], 8, timeout=120).tokens

    ev = threading.Thread(target=evictor)
    ev.start()
    try:
        workers = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(prompts))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(180.0)
        assert not any(w.is_alive() for w in workers)
    finally:
        stop.set()
        ev.join(10.0)
    assert [results[i] for i in range(len(prompts))] == want


# --------------------------------------------------------- role health/probe

def test_probe_refuses_decode_traffic_to_prefill_replicas(lm):
    _, _, model, params = lm
    pf = mk(model, params, "prefill")
    uni = mk(model, params, "unified")
    assert pf.stats()["role"] == "prefill"
    assert uni.stats()["role"] == "unified"
    pool = ReplicaPool([EngineReplica("pf", pf), EngineReplica("uni", uni)],
                       fail_threshold=1)
    pool.probe_once()
    assert not pool.is_active("pf")
    assert pool.is_active("uni")


def test_roles_are_validated(lm):
    _, _, model, params = lm
    with pytest.raises(ValueError, match="unified/prefill/decode"):
        mk(model, params, "both")
    with pytest.raises(ValueError, match="paged"):
        InferenceEngine(model, params, cfg=ServingConfig(role="prefill"),
                        device=CPU)
    dense = InferenceEngine(model, params, cfg=ServingConfig(), device=CPU)
    with pytest.raises(ValueError, match="paged"):
        dense.prefill([1, 2], 2)
    with pytest.raises(ValueError, match="paged"):
        KVMigrator(dense)
    with pytest.raises(ValueError, match="prefill-role"):
        KVMigrator(mk(model, params, "prefill"))
    assert issubclass(MigrationRejected, RuntimeError)


# ------------------------------------------------------------ HTTP migrate

def test_http_migrate_probe_and_import_roundtrip(lm, disagg):
    """``/healthz`` reports the role, the probe answers the decode pool's
    resident prefix, a full export lands with parity, and a probe-guided
    re-export ships no page (hash-only claims over HTTP)."""
    _, _, model, params = lm
    _sched, pf, dec = disagg
    prompt = [11, 12, 13, 14, 15, 16, 17, 18, 19]
    want = model.sample(params, prompt, 12, temperature=0.0,
                        kv_cache=True)[len(prompt):]
    with ModelServer(engine=dec) as server:
        client = ServingClient(port=server.port)
        health = client.healthz()
        assert health["role"] == "decode" and "warmed" in health
        probe = client.migrate_probe(prompt)
        assert probe == {"cached_len": 0, "page_size": 8}
        rec = pf.prefill(prompt, 12)
        out = client.migrate(export_payload(
            pf, rec, cached_len=probe["cached_len"]))
        assert out["tokens"] == want
        probe2 = client.migrate_probe(prompt)
        assert probe2["cached_len"] == 8
        payload2 = export_payload(pf, pf.prefill(prompt, 12),
                                  cached_len=probe2["cached_len"])
        assert payload2["pages"] == {}
        assert client.migrate(payload2)["tokens"] == want


# ---------------------------------------------- the wire, across packages

@pytest.mark.parametrize("kv_quant", PAGES)
def test_reference_payload_imports_into_the_port(kv_quant):
    """A payload the JAX package's prefill engine exports (numpy dtype
    names, base64 bytes) imports into the port's decode engine: the
    pages land byte for byte and the tokens equal the reference's."""
    jmodel, jp, model, params = _lm()
    prompt = [7, 3, 9, 1, 4, 4, 8, 2, 6, 5, 11, 30]
    jpf = mk_ref(jmodel, jp, "prefill", kv_quant=kv_quant)
    jdec = mk_ref(jmodel, jp, "decode", kv_quant=kv_quant)
    jdec.start(warmup=False)
    try:
        payload = jmig.export_payload(jpf, jpf.prefill(prompt, 8))
        want = jmig.KVMigrator(jdec).import_payload(
            jmig.export_payload(jpf, jpf.prefill(prompt, 8))).result(300)
    finally:
        jdec.stop()
    dec = mk(model, params, "decode", kv_quant=kv_quant).start(warmup=False)
    try:
        got = KVMigrator(dec).import_payload(payload).result(120)
    finally:
        dec.stop()
    assert got.tokens == want.tokens
    assert ctr("disagg.pages_moved") == 2


@pytest.mark.parametrize("kv_quant", PAGES)
def test_port_payload_imports_into_the_reference(kv_quant):
    """The reverse: the port's prefill engine exports, the JAX package's
    decode engine imports (its numpy dtypes read the port's names), and
    the tokens equal the port's own migration's."""
    jmodel, jp, model, params = _lm()
    prompt = [7, 3, 9, 1, 4, 4, 8, 2, 6, 5, 11, 30]
    pf = mk(model, params, "prefill", kv_quant=kv_quant)
    payload = export_payload(pf, pf.prefill(prompt, 8))
    dtypes = {enc["dtype"] for layer in payload["pages"]["0"]
              for enc in layer.values()}
    assert dtypes == {None: {"float32"}, "int8": {"int8", "float32"},
                      "fp8": {"float8_e4m3fn", "float32"}}[kv_quant]
    dec = mk(model, params, "decode", kv_quant=kv_quant).start(warmup=False)
    try:
        want = KVMigrator(dec).import_payload(
            export_payload(pf, pf.prefill(prompt, 8))).result(120)
    finally:
        dec.stop()
    jdec = mk_ref(jmodel, jp, "decode", kv_quant=kv_quant)
    jdec.start(warmup=False)
    try:
        got = jmig.KVMigrator(jdec).import_payload(payload).result(300)
    finally:
        jdec.stop()
    assert got.tokens == want.tokens


def test_wire_arrays_round_trip_every_page_dtype():
    """Each wire dtype name decodes to the torch dtype and bytes it was
    encoded from; a size that does not match its shape is refused."""
    from deeplearning4j_tpu_torch.serving.disagg import migrate as tmig

    for name, dt in tmig.WIRE_DTYPES.items():
        t = torch.linspace(-3, 3, 24).reshape(2, 3, 4).to(dt)
        enc = tmig._encode_arr(t)
        assert enc["dtype"] == name and enc["shape"] == [2, 3, 4]
        back = tmig._decode_arr(enc)
        assert back.dtype == dt
        assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))
        ref = jmig._decode_arr(enc)         # the reference reads it too
        np.testing.assert_array_equal(
            ref.view(np.uint8).reshape(-1),
            t.reshape(-1).view(torch.uint8).numpy())
    with pytest.raises(ValueError, match="does not hold"):
        tmig._decode_arr(dict(enc, shape=[5]))
    with pytest.raises(ValueError, match="unsupported wire dtype"):
        tmig._decode_arr(dict(enc, dtype="complex64"))
