"""The generator: the same seed gives the same inputs, every seed the
same sizes in another order, everything within its ranges."""

import json
from collections import Counter
from pathlib import Path

import torch

from h100bench.core import traffic, weights
from h100bench.core.model import model_of

ROOT = Path(__file__).resolve().parent.parent
SERVE = json.loads((ROOT / "h100bench/traffic/serve-int8-decode32.json")
                   .read_text())
TRAIN = dict(json.loads((ROOT / "h100bench/traffic/train-64x512.json")
                        .read_text()), batch=4, seq=16, batches=3)
BIG = 2 ** 31 + 12345           # seeds may pass 32 signed bits


def test_train_batches_by_seed_and_range():
    a = traffic.train_batches(TRAIN, 1000, BIG, "cpu")
    b = traffic.train_batches(TRAIN, 1000, BIG, "cpu")
    c = traffic.train_batches(TRAIN, 1000, BIG + 1, "cpu")
    assert all(torch.equal(x[0], y[0]) for x, y in zip(a, b))
    assert not torch.equal(a[0][0], c[0][0])
    toks = torch.stack([x[0] for x in a])
    assert toks.min() >= 0 and toks.max() < 1000
    assert torch.equal(a[1][1], torch.roll(a[1][0], -1, dims=1))
    rows = toks.reshape(-1, TRAIN["seq"])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]


def test_serve_plan_by_seed_same_sizes_in_another_order():
    p1 = traffic.serve_plan(SERVE, BIG)
    p2 = traffic.serve_plan(SERVE, BIG)
    p3 = traffic.serve_plan(SERVE, BIG + 7)
    assert [[r.prompt for r in c] for c in p1] == \
        [[r.prompt for r in c] for c in p2]

    def sizes(plan, ramp):
        return Counter((len(r.prompt), r.budget) for c in plan for r in c
                       if (r.index == 0) == ramp)

    for ramp in (True, False):
        assert sizes(p1, ramp) == sizes(p3, ramp)
    assert [len(r.prompt) for c in p1 for r in c] != \
        [len(r.prompt) for c in p3 for r in c]
    assert len(p1) == SERVE["clients"]
    lo, hi = SERVE["prompt_tokens"]
    for c in p1:
        assert len(c) == SERVE["requests_per_client"]
        for r in c:
            assert lo <= len(r.prompt) <= hi
            rng = SERVE["ramp_output_tokens" if r.index == 0
                        else "output_tokens"]
            assert rng[0] <= r.budget <= rng[1]
            assert all(0 <= t < SERVE["token_id_high"] for t in r.prompt)
            assert len(r.prompt) + r.budget <= 1024


def test_sizes_spread_over_their_range():
    s = traffic.spread(256, 768, 160)
    assert s.min() >= 256 and s.max() <= 768
    assert abs(s.mean() - 512) < 2


def test_weights_by_seed():
    model = model_of(json.loads((ROOT / "h100bench/configs/gpt2-small.json")
                                .read_text()))
    model.update(vocab_size=64, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                 max_len=32)
    a = weights.make(model, BIG, "cpu")
    b = weights.make(model, BIG, "cpu")
    c = weights.make(model, BIG + 1, "cpu")
    assert torch.equal(a["layers"][1]["w2"], b["layers"][1]["w2"])
    assert not torch.equal(a["tok_embed"], c["tok_embed"])
    assert torch.equal(a["layers"][0]["ln1_scale"], torch.ones(16))
    assert a["layers"][0]["wqkv"].shape == (16, 3, 2, 8)
