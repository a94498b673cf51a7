"""The yardstick's arithmetic against hand counts: each roofline's flops
and bytes at two shapes, the model-flop counts of both configurations,
and the least-time bound."""

import json
from pathlib import Path

import pytest
import torch

from h100bench.core import manifest, peaks
from h100bench.core.model import matmul_params, model_of

ROOT = Path(__file__).resolve().parent.parent


def metric(name):
    return manifest.load_metric(name)


def model(name):
    return model_of(json.loads(
        (ROOT / "h100bench" / "configs" / f"{name}.json").read_text()))


@pytest.mark.parametrize("B,T,H,Dh,causal,flops,nbytes", [
    # 4*B*H*Dh*T^2; q, k, v, o of B*T*H*Dh bf16 each
    (64, 512, 12, 64, False, 4 * 64 * 12 * 64 * 512 ** 2,
     4 * 64 * 512 * 12 * 64 * 2),
    # causal: T(T+1)/2 pairs
    (8, 2048, 12, 64, True, 4 * 8 * 12 * 64 * (2048 * 2049 // 2),
     4 * 8 * 2048 * 12 * 64 * 2),
])
def test_attention_fwd_work(B, T, H, Dh, causal, flops, nbytes):
    m = metric("attention_fwd_roofline")
    q = torch.empty((B, T, H, Dh), dtype=torch.bfloat16, device="meta")
    call = m.record(q, q, q, causal=causal)
    assert m.work(call) == (flops, nbytes, "bfloat16")


@pytest.mark.parametrize("N,D,V,flops,nbytes", [
    # 2*N*D*V; h (N, D) and head (D, V) bf16, int64 targets, f32 sum
    (32768, 768, 30522, 2 * 32768 * 768 * 30522,
     32768 * 768 * 2 + 768 * 30522 * 2 + 32768 * 8 + 4),
    (65536, 768, 50304, 2 * 65536 * 768 * 50304,
     65536 * 768 * 2 + 768 * 50304 * 2 + 65536 * 8 + 4),
])
def test_xent_fwd_work(N, D, V, flops, nbytes):
    m = metric("xent_fwd_roofline")
    h = torch.empty((N, D), dtype=torch.bfloat16, device="meta")
    head = torch.empty((D, V), dtype=torch.bfloat16, device="meta")
    t = torch.empty((N,), dtype=torch.int64, device="meta")
    assert m.work(m.record(h, head, t)) == (flops, nbytes, "bfloat16")


@pytest.mark.parametrize("M,K,N,flops,nbytes", [
    # a prefill row through w1: x 1x768 bf16, w 768x3072 int8, scales, f32 out
    (1, 768, 3072, 2 * 768 * 3072, 768 * 2 + 768 * 3072 + 3072 * 4 + 3072 * 4),
    # a decode step of 32 slots through the head
    (32, 768, 50304, 2 * 32 * 768 * 50304,
     32 * 768 * 2 + 768 * 50304 + 50304 * 4 + 32 * 50304 * 4),
])
def test_int8_matmul_work(M, K, N, flops, nbytes):
    from collections import namedtuple

    m = metric("int8_matmul_roofline")
    QW = namedtuple("QW", "q scale")
    x = torch.empty((M, K), dtype=torch.bfloat16, device="meta")
    qw = QW(torch.empty((K, N), dtype=torch.int8, device="meta"),
            torch.empty((N,), dtype=torch.float32, device="meta"))
    assert m.work(m.record(x, qw)) == (flops, nbytes, "bfloat16")


def test_train_model_flops_by_hand():
    m = metric("train_mfu")
    bert = model("bert-base")
    # 12 blocks of 4*768^2 + 2*768*3072, and the tied 30522 x 768 head
    assert matmul_params(bert) == 12 * 7_077_888 + 23_440_896
    # 6 x 108,375,552 + 12 x 12 x 768 x 512 (bidirectional)
    assert m.flops_per_token(bert, 512) == 650_253_312 + 56_623_104
    gpt = model("gpt2-small")
    assert gpt["d_ff"] == 3072 and gpt["vocab_size"] == 50304
    # causal at T=1024: (T + 1) / 2 keys a token on average
    assert m.flops_per_token(gpt, 1024) == pytest.approx(
        6 * (12 * 7_077_888 + 50304 * 768)
        + 12 * 12 * 768 * 1025 / 2)


def test_serve_model_flops_by_hand():
    m = metric("serve_mfu")
    gpt = model("gpt2-small")
    n = 12 * 7_077_888 + 50304 * 768
    # a 3-token prompt, 2 tokens served: positions 0..3 run, keys 1..4
    assert m.request_flops(gpt, 3, 2) == 4 * 2 * n + 4 * 12 * 768 * 10
    bert = model("bert-base")
    assert m.request_flops(bert, 1, 1) == 2 * matmul_params(bert) \
        + 4 * 12 * 768


def test_least_time_takes_the_larger_bound():
    p = peaks.for_card("NVIDIA H100 80GB HBM3")
    assert p.bf16_flops == 989e12 and p.bytes_per_s == 3.35e12
    assert peaks.least_time_s(989e12, 0, p.bf16_flops, p) == 1.0
    assert peaks.least_time_s(0, 3.35e12, p.bf16_flops, p) == 1.0
    assert peaks.matmul_flops_rate(p, "float32") == 67e12


def test_share_is_least_time_over_range_time():
    from types import SimpleNamespace

    from h100bench.core.roofline import share_pct
    from h100bench.core.trace import OpRanges, TraceResult

    ranges = OpRanges()
    ranges.calls["op"] = [{"f": 989e9, "b": 0}, {"f": 0, "b": 3.35e9}]
    traced = TraceResult(1.0, 0.5, [], [], {"op": 2}, {}, {"op": 0.004})
    ctx = SimpleNamespace(traced=traced, ranges=ranges,
                          peaks=peaks.for_card("H100"))
    # 1 ms + 1 ms of least time over 4 ms of device time
    assert share_pct(ctx, "op", lambda c: (c["f"], c["b"], "bfloat16")) \
        == pytest.approx(50.0)
    traced.op_range_count["op"] = 3          # a range without its call
    assert share_pct(ctx, "op", lambda c: (c["f"], c["b"],
                                           "bfloat16")) is None
