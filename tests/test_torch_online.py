"""The online learning loop of the port, against the JAX package's.

The port's counterparts of ``tests/test_online_loop.py`` (its lint tests
aside): the capture store's durability under torn tails and damaged
media, the generation-consistency invariant under a racing reload, the
canary and SLO-gated rollback of a poisoned publish, the reload fan-out
over a router, the publish / ``latest_valid_step`` writer race and a
fixed-seed chaos plan.  Beside them, the packages against each other:
either package's capture segments replay in the other, and a round on
the same captures and parameters trains the reference's trajectory.
Tiny f32 model on the CPU; parameters shared through numpy.
"""

import json
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.online import CaptureStore as JCaptureStore
from deeplearning4j_tpu.online import OnlineConfig as JOnlineConfig
from deeplearning4j_tpu.online import OnlineLoop as JOnlineLoop
from deeplearning4j_tpu.parallel.checkpoint import \
    CheckpointManager as JCheckpointManager
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.online import (CaptureStore, OnlineConfig,
                                             OnlineLoop)
from deeplearning4j_tpu_torch.parallel.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.resilience import FaultSpec, inject_faults
from deeplearning4j_tpu_torch.resilience.faults import corrupt_file
from deeplearning4j_tpu_torch.serving import (EngineReplica, InferenceEngine,
                                              PrefixRouter, RouterConfig,
                                              ServingConfig)
from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves
from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"
KW = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
          max_len=32, remat=False)
OCFG = OnlineConfig(batch=2, seq=8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def olm():
    """Tiny f32 LM in both packages, the same weights."""
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **KW)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **KW)
    jp = jtr.init_params(jax.random.key(7), jcfg)
    return (jtr.TransformerLM(jcfg), jp,
            ttr.TransformerLM(tcfg, device=CPU), params_from_numpy(_np(jp),
                                                                   CPU))


def _expected(model, params, prompt, n):
    return model.sample(params, prompt, n, temperature=0.0,
                        kv_cache=True)[len(prompt):]


def _traffic(rng, n, vocab=32):
    """Captured records: 4 prompt + 5 generated tokens each, so every 2
    records fill one (batch=2, seq=8) training block."""
    return [{"prompt": [rng.randrange(vocab) for _ in range(4)],
             "tokens": [rng.randrange(vocab) for _ in range(5)]}
            for _ in range(n)]


def _counters():
    return tobs.METRICS.snapshot()["counters"]


# --------------------------------------------------------------- capture

def test_capture_roundtrip_rotates_segments(tmp_path):
    store = CaptureStore(tmp_path, segment_bytes=256)
    recs = _traffic(random.Random(0), 12)
    for r in recs:
        store.append(r)
    assert len(store.segments()) > 1
    got = store.records()
    assert [g["prompt"] for g in got] == [r["prompt"] for r in recs]
    assert [g["tokens"] for g in got] == [r["tokens"] for r in recs]
    assert _counters()["online.captured_records"] == 12
    store.close()


def test_capture_torn_tail_truncate_keeps_verified_prefix(tmp_path):
    store = CaptureStore(tmp_path, segment_bytes=1 << 20)
    recs = _traffic(random.Random(1), 8)
    for r in recs:
        store.append(r)
    store.close()
    corrupt_file(store.segments()[0], "truncate")
    reopened = CaptureStore(tmp_path, segment_bytes=1 << 20)
    reopened.append({"prompt": [1, 2, 3, 4], "tokens": [5, 6, 7, 8, 9]})
    got = reopened.records()
    assert 0 < len(got) < 10
    for g, r in zip(got[:-1], recs):
        assert g == r
    assert got[-1]["tokens"] == [5, 6, 7, 8, 9]
    # the torn segment was sealed: the new append lives in a fresh one
    assert len(reopened.segments()) == 2
    assert _counters()["capture.corrupt_records"] > 0
    reopened.close()


def test_capture_bitflip_costs_only_covered_records(tmp_path):
    store = CaptureStore(tmp_path, segment_bytes=1 << 20)
    recs = _traffic(random.Random(2), 10)
    for r in recs:
        store.append(r)
    store.close()
    corrupt_file(store.segments()[0], "bitflip")
    got = CaptureStore(tmp_path).records()
    assert len(got) >= len(recs) - 2
    assert all(g in recs for g in got)


def test_capture_write_chaos_never_loses_the_store(tmp_path):
    store = CaptureStore(tmp_path, segment_bytes=1 << 20)
    recs = _traffic(random.Random(3), 8)
    with inject_faults(FaultSpec("capture.write", at_step=3, kind="bitflip"),
                       seed=0):
        for r in recs:
            store.append(r)
    store.close()
    assert len(store.records()) >= len(recs) - 2
    assert _counters()["faults.injected.capture.write"] == 1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_capture_segments_replay_across_packages(tmp_path, writer):
    """Each package's segments (rotated, one torn tail) replay in the
    other, record for record, with the same records skipped."""
    make = {"port": CaptureStore, "reference": JCaptureStore}
    other = {"port": JCaptureStore, "reference": CaptureStore}[writer]
    recs = _traffic(random.Random(9), 14) + [
        {"prompt": [1], "tokens": [2], "tenant": "acme", "feedback": 0.5}]
    store = make[writer](tmp_path, segment_bytes=300)
    for r in recs:
        store.append(r)
    store.close()
    segs = sorted(tmp_path.glob("capture-*.jsonl"))
    assert len(segs) > 2
    corrupt_file(segs[1], "truncate")
    mine = make[writer](tmp_path).records()
    theirs = other(tmp_path).records()
    assert theirs == mine and len(mine) < len(recs)
    assert all(r in recs for r in theirs) and theirs[-1] == recs[-1]
    assert list(other(tmp_path).replay_tenant("acme")) == [recs[-1]]


# ------------------------------------------------------------ loop plumbing

def _make_loop(tmp_path, olm, n_records=6, with_engine=False, **cfg_kw):
    _, _, model, params0 = olm
    store = CaptureStore(tmp_path / "capture")
    mgr = CheckpointManager(tmp_path / "ckpt", keep=64)
    for r in _traffic(random.Random(4), n_records):
        store.append(r)
    engine = None
    if with_engine:
        engine = InferenceEngine(model, params0, mgr, ServingConfig(
            slots=2, idle_wait_s=0.01), device=CPU)
        engine.start(warmup=False)
    loop = OnlineLoop(store, mgr, model, params0=params0, engine=engine,
                      cfg=OnlineConfig(**{**OCFG.__dict__, **cfg_kw}))
    return loop, store, mgr, engine


def test_round_trains_publishes_and_hot_reloads(tmp_path, olm):
    _, _, model, params0 = olm
    loop, store, mgr, engine = _make_loop(tmp_path, olm, with_engine=True)
    try:
        rep = loop.run_once().to_dict()
        assert rep["status"] == "ok", rep
        # 6 records x 9 tokens = 3 full (2, 9) blocks -> 3 steps
        assert rep["trained_to"] == 3 and rep["reloaded"]["engine"] == 3
        assert rep["generation"] == 1
        assert loop.run_once().to_dict()["status"] == "no_new_data"
        out = engine.submit(prompt=[5, 9, 13], max_new_tokens=4,
                            temperature=0.0, seed=11).result(60.0)
        assert (out.generation, out.loaded_step) == (1, 3)
        trained = mgr.restore(params0, step=3)["params"]
        assert out.tokens == _expected(model, trained, [5, 9, 13], 4)
        assert not torch.equal(trained["tok_embed"], params0["tok_embed"])
    finally:
        engine.stop()
    assert 0 in mgr.all_steps()
    assert loop.status()["current_step"] == 3


def test_round_trains_the_reference_trajectory(tmp_path, olm):
    """The same captures and parameters through both packages' loops: the
    published steps agree leaf by leaf (sgd on the same batches, f32; the
    summation order apart), and each package restores the other's."""
    jmodel, jp, model, params0 = olm
    recs = _traffic(random.Random(4), 6)
    stores = (CaptureStore(tmp_path / "tcap"), JCaptureStore(tmp_path / "jcap"))
    for s in stores:
        for r in recs:
            s.append(r)
    tmgr = CheckpointManager(tmp_path / "tck", keep=8)
    jmgr = JCheckpointManager(tmp_path / "jck", keep=8)
    trep = OnlineLoop(stores[0], tmgr, model, params0=params0,
                      cfg=OCFG).run_once()
    jrep = JOnlineLoop(stores[1], jmgr, jmodel, params0=jp,
                       cfg=JOnlineConfig(batch=2, seq=8)).run_once()
    assert trep.status == jrep.status == "ok"
    assert trep.trained_to == jrep.trained_to == 3
    got = tmgr.restore(params0, step=3)["params"]
    want = _np(jmgr.restore(jp, step=3)["params"])
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
    # the reference's published step restores into the port bitwise
    cross = CheckpointManager(tmp_path / "jck").restore(params0, step=3)
    for g, w in zip(tree_leaves(cross["params"]),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_generation_stamp_parity_under_concurrent_reload(tmp_path, olm):
    """Requests in flight while ``reload`` stages a new checkpoint each
    complete under ONE generation, and their stamp names it."""
    _, _, model, params0 = olm
    params1 = model.init(torch.Generator().manual_seed(23))
    mgr = CheckpointManager(tmp_path / "ckpt", keep=8)
    mgr.save(1, params1)
    engine = InferenceEngine(model, params0, mgr, ServingConfig(
        slots=2, idle_wait_s=0.005), device=CPU)
    engine.start(warmup=False)
    rng = random.Random(5)
    reqs = [dict(prompt=[rng.randrange(32) for _ in range(rng.randint(2, 5))],
                 max_new_tokens=rng.randint(2, 6), temperature=0.0,
                 seed=rng.randrange(1 << 16)) for _ in range(12)]
    outs, lock = [], threading.Lock()

    def worker(mine):
        for r in mine:
            out = engine.submit(**r).result(60.0)
            with lock:
                outs.append((r, out))

    try:
        ts = [threading.Thread(target=worker, args=(reqs[i::2],))
              for i in range(2)]
        for t in ts:
            t.start()
        engine.reload(step=1)
        for t in ts:
            t.join(120.0)
        assert not any(t.is_alive() for t in ts)
    finally:
        engine.stop()
    by_step = {None: params0, 1: params1}
    assert len(outs) == len(reqs)
    for r, out in outs:
        assert out.tokens == _expected(model, by_step[out.loaded_step],
                                       r["prompt"], len(out.tokens)), \
            (r, out.loaded_step)
    assert engine.stats()["loaded_step"] == 1


def test_poison_rollback_quarantines_and_dumps_bundle(tmp_path, olm):
    loop, store, mgr, engine = _make_loop(tmp_path, olm, with_engine=True)
    old_dump = tobs.FLIGHTREC.dump_dir
    tobs.FLIGHTREC.dump_dir = tmp_path / "rec"
    try:
        with inject_faults(
                FaultSpec("online.publish", at_step=1, kind="poison"),
                FaultSpec("online.rollback", at_step=1), seed=0):
            rep = loop.run_once().to_dict()
    finally:
        tobs.FLIGHTREC.dump_dir = old_dump
        engine.stop()
    assert rep["status"] == "rolled_back"
    assert rep["rollback_reason"] == "canary_nonfinite"
    assert rep["quarantined"].endswith("bad_0000000003")
    assert (tmp_path / "ckpt" / "bad_0000000003").is_dir()
    assert mgr.latest_valid_step() == 2
    assert engine.stats()["loaded_step"] == 2
    assert rep["generation"] == 2
    bundles = sorted((tmp_path / "rec").glob("flightrec-online_rollback-*"))
    assert bundles, "rollback must leave a flight bundle"
    extra = json.loads(bundles[-1].read_text())["extra"]
    assert extra["bad_step"] == 3 and extra["restored_step"] == 2
    assert extra["reason"] == "canary_nonfinite"
    counters = _counters()
    assert counters["checkpoint.quarantined"] >= 1
    assert counters["online.rollbacks"] >= 1


def test_slo_breach_during_probation_rolls_back(tmp_path, olm):
    """A healthy canary is not enough: a breach in the SLO evaluator during
    the probation window condemns the generation too."""

    class _BreachesAfterSwap:
        def __init__(self):
            self.calls = 0

        def status(self):
            self.calls += 1
            return {"breaches": 0 if self.calls == 1 else 1}

    loop, store, mgr, _ = _make_loop(tmp_path, olm, probation_s=0.02,
                                     probation_poll_s=0.005)
    loop.slo = _BreachesAfterSwap()
    rep = loop.run_once().to_dict()
    assert rep["status"] == "rolled_back"
    assert rep["rollback_reason"] == "slo_breach"
    assert mgr.latest_valid_step() == 2


def test_router_reload_fans_out_to_every_replica(tmp_path, olm):
    _, _, model, params0 = olm
    params1 = model.init(torch.Generator().manual_seed(29))
    mgr = CheckpointManager(tmp_path / "ckpt", keep=8)
    mgr.save(1, params1)
    engines = [InferenceEngine(model, params0, mgr, ServingConfig(
        slots=2, idle_wait_s=0.01), device=CPU) for _ in range(2)]
    for e in engines:
        e.start(warmup=False)
    reps = [EngineReplica(f"r{i}", e, own_engine=True)
            for i, e in enumerate(engines)]
    router = PrefixRouter(reps, RouterConfig())
    try:
        assert router.reload(step=1) == {"r0": 1, "r1": 1}
        for e in engines:
            assert e.stats()["loaded_step"] == 1
        got = router.generate([3, 1, 4], 4, temperature=0.0, seed=9)
        assert got["tokens"] == _expected(model, params1, [3, 1, 4], 4)
    finally:
        router.close()


def test_publish_race_latest_valid_step_never_sees_torn_checkpoint(tmp_path,
                                                                   olm):
    """Writers publish steps while a reader spins on
    ``latest_valid_step`` + ``restore``: a step is either invisible or
    fully restorable."""
    _, _, _, params0 = olm
    mgr = CheckpointManager(tmp_path / "ckpt", keep=64)
    errors: list[str] = []
    stop = threading.Event()

    def writer(steps):
        try:
            for s in steps:
                mgr.save(s, params0)
        except Exception as e:                     # noqa: BLE001
            errors.append(f"writer: {e!r}")

    def reader():
        seen = 0
        while not stop.is_set():
            try:
                s = mgr.latest_valid_step()
                if s is not None:
                    assert s >= seen, f"latest_valid_step went back: {s}"
                    seen = s
                    mgr.restore(params0, step=s)
            except Exception as e:                 # noqa: BLE001
                errors.append(f"reader: {e!r}")
                return

    ws = [threading.Thread(target=writer, args=(range(1, 17, 2),)),
          threading.Thread(target=writer, args=(range(2, 17, 2),))]
    rd = threading.Thread(target=reader)
    rd.start()
    for w in ws:
        w.start()
    for w in ws:
        w.join(120.0)
    stop.set()
    rd.join(30.0)
    assert not errors, errors
    assert mgr.latest_valid_step() == 16
    assert set(mgr.all_steps()) == set(range(1, 17))


def test_fixed_seed_chaos_plan_rolls_back_then_heals(tmp_path, olm):
    """A step fault inside the fine-tune, a poisoned publish, a failing
    rollback seam and an aborted reload: three rounds later serving is on
    the cleanly republished step."""
    _, _, model, params0 = olm
    loop, store, mgr, engine = _make_loop(tmp_path, olm, with_engine=True)
    try:
        with inject_faults(FaultSpec("train.step", at_step=2),
                           FaultSpec("online.publish", at_step=1,
                                     kind="poison"),
                           FaultSpec("online.rollback", at_step=1),
                           FaultSpec("online.reload", at_step=2), seed=7):
            statuses = [loop.run_once().to_dict()["status"]
                        for _ in range(3)]
        assert statuses == ["rolled_back", "reload_fault", "ok"]
        counters = _counters()
        for site in ("train.step", "online.publish", "online.rollback",
                     "online.reload"):
            assert counters[f"faults.injected.{site}"] == 1, site
        assert engine.stats()["loaded_step"] == 3
        out = engine.submit(prompt=[2, 7, 1], max_new_tokens=4,
                            temperature=0.0, seed=3).result(60.0)
        healed = mgr.restore(params0, step=3)["params"]
        assert out.tokens == _expected(model, healed, [2, 7, 1], 4)
        assert out.loaded_step == 3
    finally:
        engine.stop()


def test_server_captures_served_traffic(tmp_path, olm):
    """``ModelServer(capture=CaptureStore)`` appends every completed
    generation (prompt, tokens, feedback, raw tenant, weight generation),
    and the loop trains on it."""
    from deeplearning4j_tpu_torch.serving import ModelServer, ServingClient

    _, _, model, params0 = olm
    store = CaptureStore(tmp_path / "capture")
    engine = InferenceEngine(model, params0, cfg=ServingConfig(slots=2),
                             device=CPU)
    with engine, ModelServer(engine, capture=store) as server:
        client = ServingClient(port=server.port, timeout_s=60)
        outs = [client.generate([i + 1, 2, 3, 4], max_new_tokens=5,
                                tenant="acme" if i % 2 else "")
                for i in range(4)]
    recs = store.records()
    assert [r["tokens"] for r in recs] == [o["tokens"] for o in outs]
    assert [r["tenant"] for r in recs] == [None, "acme", None, "acme"]
    assert all(r["generation"] == 0 for r in recs)
    mgr = CheckpointManager(tmp_path / "ckpt", keep=8)
    rep = OnlineLoop(store, mgr, model, params0=params0,
                     cfg=OCFG).run_once().to_dict()
    assert rep["status"] == "ok" and rep["trained_to"] == 2
