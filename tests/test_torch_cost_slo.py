"""Cost capture, utilization, SLOs, time series and the kernel-tier
gauges of the port, against the reference where the reference has the
same arithmetic.

``CostModel.capture`` counts a function on fake tensors: a GEMM chain
counts exactly ``2·M·N·K`` a product, a kernel wrapper's fake branch
credits its own work and launches nothing, and a captured train step or
engine decode step leaves every tensor bitwise as it was.  The same
scripted series through both packages' ``TimeSeriesStore`` +
``SLOEvaluator`` gives equal burn rates and the same breaches.  The
capture on the card is in ``test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.observability as jobs
from deeplearning4j_tpu.observability import kernels as jkernels
from deeplearning4j_tpu.ops.pallas import registry as jregistry
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.observability import cost as tcost
from deeplearning4j_tpu_torch.observability import kernels as tkernels
from deeplearning4j_tpu_torch.ops.cuda import attention as tat
from deeplearning4j_tpu_torch.ops.cuda import layernorm as tln
from deeplearning4j_tpu_torch.ops.cuda import matmul_int8 as tmm
from deeplearning4j_tpu_torch.ops.cuda import paged_attention as tpa
from deeplearning4j_tpu_torch.ops.cuda import registry as tregistry
from deeplearning4j_tpu_torch.ops.cuda import xent as txe
from deeplearning4j_tpu_torch.optimize import transforms as TT
from deeplearning4j_tpu_torch.parallel import DataParallelTrainer
from deeplearning4j_tpu_torch.serving import InferenceEngine, ServingConfig
from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves
from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"
TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=32, dtype=torch.float32, remat=False, xent_chunk=0)


def _snapshot(tree):
    return [t.detach().clone() if torch.is_tensor(t) else t
            for t in tree_leaves(tree)]


def _bitwise_same(before, tree) -> bool:
    after = tree_leaves(tree)
    return len(before) == len(after) and all(
        (torch.equal(a, b) and a.dtype == b.dtype) if torch.is_tensor(a)
        else a == b for a, b in zip(before, after))


# ------------------------------------------------------------------ capture
@pytest.mark.parametrize("dims", [(8, 16, 32, 4), (3, 5, 7, 11),
                                  (64, 128, 256, 32)])
def test_capture_counts_two_mnk_a_product(dims):
    """A chain of products (and the elementwise op between them) counts
    exactly 2·M·N·K per product; the chain's result is never computed."""
    m, k, n, p = dims
    gen = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(s, generator=gen) for s in ((m, k), (k, n),
                                                        (n, p)))

    def chain(a, b, c):
        return torch.relu(a @ b) @ c

    info = tobs.COSTS.capture(f"chain.{m}", chain, a, b, c)
    assert info.source == "counted"
    assert info.flops == 2 * m * k * n + 2 * m * n * p
    # bytes: each op's operands read once, its result written once
    f32 = 4
    assert info.bytes_accessed == f32 * (
        (m * k + k * n + m * n) + 2 * m * n + (m * n + n * p + m * p))
    assert tobs.COSTS.get(f"chain.{m}") is info
    # cached per signature: the same shapes return the same record
    assert tobs.COSTS.capture(f"chain.{m}", chain, a, b, c) is info


def test_metadata_views_and_allocations_move_no_bytes():
    """A device or size query, a view and an empty allocation count
    nothing; a copy counts its bytes twice (read, write)."""
    x = torch.ones(64, 32)

    def meta(x):
        assert x.device.type == "cpu" and x.shape[0] == 64
        torch.empty_like(x)
        return x.view(-1)[:10]

    assert tcost.count_work(meta, x) == (0.0, 0.0)
    assert tcost.count_work(lambda x: x.clone(), x) == (0.0, 2 * 64 * 32 * 4)


def test_capture_falls_back_and_never_raises():
    def boom(x):
        raise RuntimeError("not countable")

    x = torch.ones(3)
    assert tobs.COSTS.capture("boom", boom, x) is None
    info = tobs.COSTS.capture("boom2", boom, x, analytic_flops=123.0)
    assert info.flops == 123.0 and info.source == "analytic"
    tobs.disable()
    try:
        assert tobs.COSTS.capture("off", torch.sin, x) is None
    finally:
        tobs.enable()


def _fake_cuda_kernels():
    """Every kernel wrapper on fake CUDA tensors (made inside the count,
    so no card is needed): the work each fake branch credits."""
    bf = torch.bfloat16
    x = torch.randn(8, 768, device="cuda", dtype=bf)
    q = torch.zeros(768, 3072, dtype=torch.int8, device="cuda")
    tmm.int8_matmul(x, tmm.QuantizedLinear(q, torch.ones(3072,
                                                          device="cuda")))
    qq = torch.randn(8, 12, 64, device="cuda", dtype=bf)
    pages = torch.zeros(129, 16, 12, 64, device="cuda", dtype=bf)
    bt = torch.zeros(8, 128, dtype=torch.int32, device="cuda")
    ln = torch.ones(8, dtype=torch.int32, device="cuda")
    tpa.paged_attention(qq, pages, pages, bt, ln)
    a = torch.randn(2, 256, 12, 64, device="cuda", dtype=bf)
    tat.fused_attention(a, a, a)
    h = torch.randn(512, 768, device="cuda", dtype=bf)
    w = torch.ones(768, device="cuda")
    tln.fused_residual_layernorm(h, h, w, w)
    head = torch.randn(768, 1024, device="cuda", dtype=bf)
    txe.xent_fwd(h, head, torch.zeros(512, dtype=torch.int32, device="cuda"),
                 torch.ones(512, device="cuda"))


def test_kernel_fake_branches_credit_their_work_and_launch_nothing():
    wrappers = (tmm.int8_matmul, tpa.paged_attention, tat.fused_attention,
                tln.fused_residual_layernorm, txe.blocked_cross_entropy)
    before = [w.launches for w in wrappers]
    flops, nbytes = tcost.count_work(_fake_cuda_kernels)
    assert [w.launches for w in wrappers] == before
    want_flops = (2 * 8 * 768 * 3072                     # int8_matmul
                  + 4 * 8 * 128 * 16 * 12 * 64           # paged, all pages
                  + 4 * 2 * 12 * 64 * (256 * 257 // 2)   # causal frontier
                  + 9 * 512 * 768                        # residual LN
                  + 2 * 512 * 1024 * 768)                # xent
    assert flops == want_flops
    assert nbytes > 2 * 768 * 1024          # at least the head's bytes


def test_captured_train_step_changes_no_state():
    """``capture`` of a train step (the trainer's own capture path) leaves
    the parameters and the optimizer state bitwise unchanged, and a fit
    then publishes finite ``train.mfu`` / ``train.mbu``."""
    cfg = ttr.TransformerConfig(**TINY)
    model = ttr.TransformerLM(cfg, device=CPU)
    params = model.init(torch.Generator().manual_seed(1))
    tx = TT.adamw(TT.warmup_cosine(1e-3, 2, 100), weight_decay=0.01)
    step = model.build_train_step(tx)
    opt = model.init_opt(params, tx)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, 64, (4, 16)))
    tgts = torch.roll(toks, -1, 1)
    # one real step first, so the moments are not all zero
    params, opt, _ = step(params, opt, toks, tgts)
    p_before, o_before = _snapshot(params), _snapshot(opt)
    info = tobs.COSTS.capture("train.tiny", step, params, opt, toks, tgts)
    assert info is not None and info.flops > 0 and info.bytes_accessed > 0
    assert _bitwise_same(p_before, params)
    assert _bitwise_same(o_before, opt)
    # the matmul work of fwd + bwd is at least 3x the forward's
    fwd = tobs.COSTS.capture(
        "fwd.tiny", lambda p, t, y: ttr.lm_loss_local(p, t, y, cfg), params,
        toks, tgts)
    assert info.flops >= 3 * fwd.flops

    trainer = DataParallelTrainer(
        lambda p, x, y, g: ttr.lm_loss_local(p, x, y, cfg), tx, device=CPU)
    state = trainer.init_state(params, key=0)
    data = [(rng.integers(0, 64, (4, 16)),) * 2 for _ in range(3)]
    state, losses = trainer.fit(state, [(x, np.roll(x, -1, 1))
                                        for x, _ in data],
                                async_dispatch=False)
    assert trainer._step_cost is not None and trainer._step_cost.flops > 0
    gauges = tobs.METRICS.snapshot()["gauges"]
    assert math.isfinite(gauges["train.mfu"]) and gauges["train.mfu"] > 0
    assert math.isfinite(gauges["train.mbu"]) and gauges["train.mbu"] > 0


def test_engine_warmup_capture_changes_no_state():
    """Warmup counts the decode step on fake copies of the engine state:
    the state is bitwise the same after the count, and the fences then
    publish ``serving.decode_mfu`` / ``decode_mbu`` in (0, 1] (nominal
    CPU peaks)."""
    cfg = ttr.TransformerConfig(**TINY)
    model = ttr.TransformerLM(cfg, device=CPU)
    params = model.init(torch.Generator().manual_seed(2))
    engine = InferenceEngine(model, params, cfg=ServingConfig(
        slots=2, paged=True, page_size=4, int8_decode=True,
        paged_attention_impl="pallas"), device=CPU)
    state_before = _snapshot(engine._state)
    engine._capture_costs(engine._params)
    assert _bitwise_same(state_before, engine._state)
    dec = engine._decode_cost
    assert dec is not None and dec.source == "counted" and dec.flops > 0
    # per decode step at least the FFN and head products of every slot
    assert dec.flops >= 2 * 2 * (cfg.n_layers * 2 * cfg.d_model * cfg.d_ff
                                 + cfg.d_model * cfg.vocab_size)
    with engine:
        engine.generate([1, 2, 3, 4, 5, 6], 6)
    g = tobs.METRICS.snapshot()["gauges"]
    assert 0 < g["serving.decode_mfu"] <= 1
    assert 0 < g["serving.decode_mbu"] <= 1
    # the first prompt's bucket (8) holds 7 counted prefill tokens
    pre = tobs.COSTS.get("serving.prefill.b8")
    assert pre.flops == 7 * engine._prefill_token_cost.flops


# ----------------------------------------------------------- utilization
def test_publish_utilization_arithmetic():
    reg = tobs.MetricsRegistry()
    info = tobs.CostInfo(flops=3e9, bytes_accessed=8e8, source="counted")
    mfu = tobs.COSTS.publish_utilization(info, 0.5, "x.mfu", "x.mbu",
                                         registry=reg)
    peak_f, peak_b = tobs.COSTS.peak_flops(), tobs.COSTS.peak_bytes_per_s()
    assert (peak_f, peak_b) == (5e10, 2e10)        # the nominal CPU rows
    assert mfu == 3e9 / (0.5 * peak_f)
    g = reg.snapshot()["gauges"]
    assert g["x.mfu"] == mfu and g["x.mbu"] == 8e8 / (0.5 * peak_b)
    assert tobs.COSTS.publish_utilization(None, 1.0, "y") is None
    assert tobs.COSTS.publish_utilization(info, 0.0, "y") is None
    assert tcost._lookup(tcost.PEAK_FLOPS, "NVIDIA H100 80GB HBM3") == 989e12
    assert tcost._lookup(tcost.PEAK_BYTES_PER_S,
                         "NVIDIA H100 80GB HBM3") == 3.35e12
    assert not any("tpu" in k for k in tcost.PEAK_FLOPS)


# ------------------------------------------------------------ SLOs
def _scripted(P, seed, objectives, n=160, dt=0.5):
    """Drive one package's store + evaluator with a seeded series."""
    reg = P.MetricsRegistry()
    store = P.TimeSeriesStore(registry=reg, ring=128)
    rec = P.FlightRecorder(None)
    dumps = []
    rec.dump = lambda trigger, extra=None: dumps.append(
        (trigger, extra["objective"], [w["burn"] for w in extra["windows"]]))
    slo = P.SLOEvaluator(objectives(P), store, registry=reg, flightrec=rec,
                         breach_cooldown_s=5.0)
    rng = np.random.default_rng(seed)
    burns = []
    for i in range(n):
        t = 100.0 + i * dt
        wave = 0.5 + 0.45 * math.sin(i / 9.0)
        reg.gauge("serving.ttft.p99", float(wave + rng.normal(0, 0.05)))
        reg.gauge("goodput.fraction", float(1 - wave / 2))
        reg.increment("serving.requests", float(rng.integers(5, 20)))
        reg.increment("serving.rejected", float(rng.integers(0, 3)))
        store.sample_once(t=t)
        burns.append({k: v for k, v in reg.snapshot()["gauges"].items()
                      if k.startswith("slo.burn_rate.")})
    return burns, dumps, slo


def _objectives(P):
    return [P.SLObjective("ttft", "upper", "serving.ttft.p99", 0.6,
                          budget=0.1, windows=(5.0, 20.0)),
            P.SLObjective("goodput", "lower", "goodput.fraction", 0.78,
                          budget=0.2, windows=(10.0,)),
            P.SLObjective("errors", "rate", "serving.rejected", 0.05,
                          denominator="serving.requests",
                          windows=(4.0, 16.0))]


@pytest.mark.parametrize("seed", range(3))
def test_slo_burn_rates_and_breaches_equal_the_reference(seed):
    port, pd, ps = _scripted(tobs, seed, _objectives)
    ref, rd, rs = _scripted(jobs, seed, _objectives)
    assert [sorted(b) for b in port] == [sorted(b) for b in ref]
    for bp, br in zip(port, ref):
        for k in bp:
            assert bp[k] == pytest.approx(br[k], rel=1e-12, abs=0)
    assert pd == rd and len(pd) > 0
    assert ps.breach_times == rs.breach_times
    assert ps.status()["breaches"] == rs.status()["breaches"]


def test_default_objectives_equal_the_reference():
    for fn in ("default_serving_objectives", "default_training_objectives"):
        assert getattr(tobs, fn)() == [
            tobs.SLObjective(**o.__dict__) for o in getattr(jobs, fn)()]


def test_timeseries_store_jsonl_and_read_back(tmp_path):
    from deeplearning4j_tpu_torch.observability import timeseries as tts

    reg = tobs.MetricsRegistry()
    store = tobs.TimeSeriesStore(registry=reg, ring=4, out_dir=tmp_path)
    for i in range(6):
        reg.increment("c")
        reg.gauge("g", float(i))
        reg.observe_time("t", 0.1 * (i + 1))
        store.sample_once(t=float(i))
    assert store.stats()["dropped"]["g"] == 2
    assert store.series("g") == [(2.0, 2.0), (3.0, 3.0), (4.0, 4.0),
                                 (5.0, 5.0)]
    assert store.last("c") == 6.0 and "t.p50" in store.names()
    with open(store.out_path, "a") as f:
        f.write('{"t": 9, "seri')                       # a torn tail
    rows = tts.read_back(store.out_path)
    assert len(rows) == 6
    merged = tts.read_back_series([store.out_path])
    assert merged["g"][-1] == (5.0, 5.0)
    assert store.start() and store.running
    store.stop()
    assert not store.running


# ------------------------------------------------------------ kernel tier
def test_publish_autopick_and_record_kernel_time_equal_the_reference():
    picks = [("paged_attention", "gather", "default (gather: ...)", [], 0),
             ("int8_matmul", "cuda", "TUNE: cuda ...", [{"candidate": "x",
                                                         "reason": "y"}], 7)]
    for kind, choice, reason, dropped, n in picks:
        tkernels.publish_autopick(tregistry.Pick(kind, choice, reason,
                                                 dropped, n))
        jkernels.publish_autopick(jregistry.Pick(kind, choice, reason,
                                                 dropped, n))
    for ms, nb in ((0.004, 1 << 20), (0.25, None)):
        tkernels.record_kernel_time("int8", "cuda", ms / 1e3, nb)
        jkernels.record_kernel_time("int8", "pallas", ms / 1e3, nb)
    ts, js = tobs.METRICS.snapshot(), jobs.METRICS.snapshot()
    assert {k: v for k, v in ts["gauges"].items() if "autopick" in k} == \
        {k: v for k, v in js["gauges"].items() if "autopick" in k}
    assert ts["counters"]["bench.autopick.decisions"] == \
        js["counters"]["bench.autopick.decisions"] == 2
    assert ts["gauges"]["kernel.int8.cuda.bytes_per_call"] == \
        js["gauges"]["kernel.int8.pallas.bytes_per_call"]
    assert ts["timers"]["kernel.int8.cuda"]["count"] == 2


def test_the_port_registry_publishes_its_autopick():
    pick = tregistry.autopick("paged_attention", [], incumbent="gather")
    assert pick.choice == "gather"
    g = tobs.METRICS.snapshot()["gauges"]
    assert g["bench.autopick.paged_attention.adopted"] == 0.0
    assert g["bench.autopick.paged_attention.candidates"] == 0
    assert tobs.METRICS.snapshot()["counters"][
        "bench.autopick.decisions"] == 1
