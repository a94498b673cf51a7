"""Device-timed spans in the LM train step (``observability/tracing.py``,
``models/transformer.py``'s ``_build_step``, the training kernels'
autograd Functions) on the CPU build of torch, where a span's
``device_ms`` is its host duration.

A tiny ``TransformerLM`` that routes through ``_Attention`` (flash),
``_ResidualLayerNorm`` (the fused mid-block seam, one a layer) and
``_BlockedXent``, with remat off and on: one step's spans, their parents
and trace, what disables them (the flag, fake tensors), the profiler's
ranges and clock, the transfer guard, and the kernel-time histograms.
The card test holds the phases' device time to CUDA events around the
whole step; run it with
``python -m pytest tests/test_torch_step_spans.py -q -m cuda --noconftest``.
"""

import threading
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.analysis import runtime as rt
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.observability import tracing
from deeplearning4j_tpu_torch.optimize import transforms as TT
from torch_port_obs import port_obs  # noqa: F401  (autouse)

L = 2
PHASES = ("lm.forward", "lm.backward", "lm.optimizer")
BACKWARDS = ("kernel.attention.backward", "kernel.xent.backward",
             "kernel.layernorm.backward")


def make_step(remat: bool, device="cpu", **kw):
    """A tiny LM's step, state and one batch: flash attention over
    128-token blocks, the fused LN seam, the blocked xent (the token count
    exceeds ``xent_chunk``)."""
    shape = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=L, d_ff=64,
                 max_len=128, dtype=torch.float32, batch=2)
    shape.update(kw)
    batch = shape.pop("batch")
    cfg = ttr.TransformerConfig(causal=True, attention="flash",
                                fused_ln=True, xent_impl="blocked",
                                xent_chunk=64, remat=remat, **shape)
    model = ttr.TransformerLM(cfg, device=device)
    params = model.init(torch.Generator().manual_seed(0))
    tx = TT.adamw(1e-3)
    opt = model.init_opt(params, tx)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_len),
                           generator=gen).to(device)
    return model.build_train_step(tx), params, opt, tokens


def events():
    tobs.TRACER.drain()
    return list(tobs.TRACER.events)


def by_name(evs):
    out = {}
    for e in evs:
        out.setdefault(e["name"], []).append(e)
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_one_step_yields_its_spans_in_one_trace(remat):
    step, params, opt, tokens = make_step(remat)
    tobs.TRACER.clear()
    step(params, opt, tokens, tokens)
    evs = events()
    counts = Counter(e["name"] for e in evs)
    assert counts["lm.step"] == 1
    for name in PHASES:
        assert counts[name] == 1, name
    assert counts["kernel.attention.backward"] == L
    assert counts["kernel.xent.backward"] == 1
    assert counts["kernel.layernorm.backward"] == L
    assert counts["kernel.xent.forward"] == 1
    assert counts["kernel.attention.forward"] == (2 * L if remat else L)
    assert len({e["args"]["trace_id"] for e in evs}) == 1
    assert all(e["args"]["device_ms"] > 0 for e in evs)
    spans = by_name(evs)
    root = spans["lm.step"][0]["args"]
    assert root["parent_span_id"] is None
    for name in PHASES:
        assert spans[name][0]["args"]["parent_span_id"] == root["span_id"]


@pytest.mark.parametrize("remat", [False, True])
def test_kernel_backwards_and_the_remat_forwards_join_lm_backward(remat):
    step, params, opt, tokens = make_step(remat)
    tobs.TRACER.clear()
    step(params, opt, tokens, tokens)
    spans = by_name(events())
    fwd = spans["lm.forward"][0]["args"]["span_id"]
    bwd = spans["lm.backward"][0]["args"]["span_id"]
    for name in BACKWARDS:
        for e in spans[name]:
            assert e["args"]["parent_span_id"] == bwd, name
            assert e["args"]["parent"] == "lm.backward"
    parents = Counter(e["args"]["parent_span_id"]
                      for e in spans["kernel.attention.forward"])
    assert parents[fwd] == L
    assert parents[bwd] == (L if remat else 0)
    attn = spans["kernel.attention.forward"][0]["args"]
    assert attn["shape"] == (2, 128, 2, 16) and attn["causal"] is True
    assert attn["dtype"] == "float32"
    xent = spans["kernel.xent.forward"][0]["args"]
    assert xent["shape"] == (256, 32) and xent["vocab"] == 64


def test_a_device_timed_span_on_another_thread_joins_the_adopter():
    t = torch.zeros(2)
    seen = {}

    def worker():
        with tracing.span("kernel.probe.backward", device=t):
            pass
        with tracing.span("plain.host.span"):
            pass
        seen["done"] = True

    with tracing.span("lm.backward", device=t) as sp, tracing.adopting(sp):
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive() and seen["done"]
    spans = by_name(events())
    probe = spans["kernel.probe.backward"][0]["args"]
    assert probe["parent_span_id"] == sp.span_id
    assert probe["trace_id"] == sp.trace_id and probe["depth"] == 1
    # a host-only span on that thread is not adopted
    assert spans["plain.host.span"][0]["args"]["parent_span_id"] is None


def test_disabled_observability_records_no_span_and_no_event():
    step, params, opt, tokens = make_step(False)
    tobs.TRACER.clear()
    tobs.disable()
    assert tracing.span("lm.step", device=tokens) is tobs.NOOP_SPAN
    step(params, opt, tokens, tokens)
    assert not tobs.TRACER.events
    assert tobs.TRACER.drain() == 0
    assert not tobs.TRACER._device_events._free
    assert "kernel.attention.backward" not in tobs.METRICS.snapshot()[
        "timers"]


def test_a_cost_count_of_the_step_records_no_span():
    step, params, opt, tokens = make_step(True)
    tobs.TRACER.clear()
    info = tobs.COSTS.capture("lm.step", step, params, opt, tokens, tokens)
    assert info is not None and info.flops > 0
    assert not events()


@pytest.mark.parametrize("remat", [False, True])
def test_spans_enter_the_profiler_on_one_clock(remat):
    step, params, opt, tokens = make_step(remat)
    params, opt, _ = step(params, opt, tokens, tokens)
    tobs.TRACER.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, tokens, tokens)
    trace = tobs.TRACER.to_chrome_trace()
    origin = trace["metadata"]["ts_origin_unix_ns"]
    ours = by_name(trace["traceEvents"])
    theirs = {}
    for e in prof.profiler.kineto_results.events():
        theirs.setdefault(e.name(), []).append(e.start_ns())
    assert set(ours) <= set(theirs)
    for name, evs in ours.items():
        starts = sorted(theirs[name])
        assert len(starts) == len(evs), name
        for ev, start_ns in zip(sorted(evs, key=lambda e: e["ts"]), starts):
            assert abs(origin + ev["ts"] * 1e3 - start_ns) < 100e3, name
    # host-only spans are mirrored too
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("host.only"):
            pass
    assert "host.only" in {e.name() for e in
                           prof.profiler.kineto_results.events()}


@pytest.mark.parametrize("remat", [False, True])
def test_the_instrumented_step_passes_the_transfer_guard(monkeypatch, remat):
    monkeypatch.setattr(rt, "GUARDED_DEVICES", ("cpu",))
    monkeypatch.delenv(rt.ENV_FLAG, raising=False)
    rt.reset_counts()
    step, params, opt, tokens = make_step(remat)
    tobs.TRACER.clear()
    with rt.hot_loop_guard() as mode:
        assert mode == "disallow"
        for _ in range(2):
            params, opt, loss = step(params, opt, tokens, tokens)
            tobs.TRACER.drain()
    assert rt.counts()["refused"] == 0
    assert Counter(e["name"] for e in events())["lm.step"] == 2
    rt.reset_counts()


def test_resolved_kernel_spans_feed_the_kernel_time_histograms():
    step, params, opt, tokens = make_step(False)
    step(params, opt, tokens, tokens)
    events()
    timers = tobs.METRICS.snapshot()["timers"]
    assert timers["kernel.attention.backward"]["count"] == L
    assert timers["kernel.attention.forward"]["count"] == L
    assert timers["kernel.layernorm.backward"]["count"] == L
    assert timers["kernel.xent.backward"]["count"] == 1
    assert timers["kernel.xent.forward"]["count"] == 1
    assert "kernel.lm.step" not in timers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (device-timed spans on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_phases_device_time_adds_up_to_the_step_on_the_card(card):
    step, params, opt, tokens = make_step(
        True, card, vocab_size=8192, d_model=512, n_heads=8, d_ff=2048,
        max_len=512, dtype=torch.bfloat16, batch=16)
    for _ in range(2):
        params, opt, _ = step(params, opt, tokens, tokens)
    torch.cuda.synchronize()
    tobs.TRACER.clear()
    whole = []
    for _ in range(4):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        params, opt, _ = step(params, opt, tokens, tokens)
        end.record()
        whole.append((start, end))
    torch.cuda.synchronize()
    assert tobs.TRACER.drain() == 0
    spans = by_name(tobs.TRACER.events)
    assert len(spans["lm.step"]) == 4
    step_ms = sum(a.elapsed_time(b) for a, b in whole)
    phases_ms = sum(e["args"]["device_ms"] for n in PHASES
                    for e in spans[n])
    assert abs(phases_ms - step_ms) <= 0.05 * step_ms, (phases_ms, step_ms)
    # autograd runs the backward on its device thread: the kernels'
    # backwards still join lm.backward of their own step
    bwd = {e["args"]["trace_id"]: e["args"]["span_id"]
           for e in spans["lm.backward"]}
    for name in BACKWARDS:
        assert len(spans[name]) == 4 * (1 if "xent" in name else L), name
        for e in spans[name]:
            assert e["args"]["parent_span_id"] == bwd[e["args"]["trace_id"]]
            assert e["args"]["device_ms"] > 0
    # an exhausted pool keeps the host timing and counts the drop
    small = tracing.Tracer()
    small._device_events = tracing._DeviceEvents(2)
    with small.span("outer", device=tokens):
        with small.span("inner", device=tokens):
            pass
    torch.cuda.synchronize()
    small.drain()
    got = {e["name"]: e["args"] for e in small.events}
    assert "device_ms" in got["outer"] and "device_ms" not in got["inner"]
    assert tobs.METRICS.snapshot()["counters"]["trace.dropped_events"] == 1
