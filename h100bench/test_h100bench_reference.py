"""The plain reference against the port's CPU path at a small size, in
float32: the loss and every gradient, two AdamW steps of
``build_train_step``, and greedy decoding through the paged engine's
step teacher-forced through the reference."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from h100bench.core import traffic, weights
from h100bench.core.model import model_of, port_config
from h100bench.reference import compare, lm

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=96, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=128)


def config(name: str, **over) -> tuple:
    cfg = json.loads((ROOT / f"h100bench/configs/{name}.json").read_text())
    model = dict(model_of(cfg), **TINY, **over)
    return cfg, model


def port(model, settings):
    from deeplearning4j_tpu_torch.models import transformer as ttr

    s = dict(settings, dtype="float32")
    return ttr, port_config(model, s, ttr, torch)


@pytest.mark.parametrize("name", ["bert-base", "gpt2-small"])
def test_loss_and_gradients_match_the_port(name):
    cfg, model = config(name)
    ttr, pcfg = port(model, cfg["train"])
    params = weights.make(model, 3, "cpu")
    tr = {"batch": 2, "seq": 128, "batches": 1}
    toks, tgts = traffic.train_batches(tr, model["vocab_size"], 5, "cpu")[0]
    flat = lm.leaves(params)
    live = {k: v.detach().clone().requires_grad_(True)
            for k, v in flat.items()}
    tree = lm._unflatten(params, live)
    loss = ttr.lm_loss_local(tree, toks, tgts, pcfg)
    got = torch.autograd.grad(loss, list(live.values()))
    with lm.exact_float32():
        ref_loss, ref = lm.grads(params, toks, tgts, model, rows=1)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    for (k, _), g in zip(live.items(), got):
        scale = ref[k].abs().max().item() or 1.0
        assert (g - ref[k]).abs().max().item() <= 1e-4 * scale, k


def test_two_adamw_steps_match_the_port():
    from deeplearning4j_tpu_torch.optimize import transforms as TT

    cfg, model = config("bert-base")
    ttr, pcfg = port(model, cfg["train"])
    o = dict(cfg["train"]["optimizer"], lr=1e-2, warmup_steps=1)
    m = ttr.TransformerLM(pcfg, device="cpu")
    tx = TT.adamw(TT.warmup_cosine(o["lr"], o["warmup_steps"],
                                   o["total_steps"]),
                  weight_decay=o["weight_decay"])
    params = weights.make(model, 4, "cpu")
    opt = m.init_opt(params, tx)
    step = m.build_train_step(tx)
    batches = traffic.train_batches({"batch": 2, "seq": 128, "batches": 3},
                                    model["vocab_size"], 6, "cpu")
    p = params
    for i in range(3):
        p, opt, _ = step(p, opt, *batches[i])
    ref = compare.reference_train(weights.make(model, 4, "cpu"), batches,
                                  model, o, 3, rows=2)
    change = compare.norms({k: v - lm.leaves(params)[k]
                            for k, v in lm.leaves(p).items()})
    worst, leaf = compare.worst_leaf(change, ref["change_norms"])
    assert worst < 1e-4, leaf


def test_served_greedy_tokens_have_no_gap_in_float32():
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.serving import engine as eng

    cfg, model = config("gpt2-small")
    pcfg = port_config(model, dict(cfg["serve"], dtype="float32"), ttr,
                       torch)
    params = weights.make(model, 8, "cpu")
    scfg = eng.ServingConfig(**dict(cfg["serve"]["engine"], slots=2,
                                    int8_decode=False, kv_quant=None,
                                    paged_attention_impl="gather"))
    e = eng.InferenceEngine(ttr.TransformerLM(pcfg, device="cpu"), params,
                            cfg=scfg, device="cpu").start()
    try:
        prompt = list(range(5, 17))
        served = e.generate(prompt, 20, timeout=120).tokens
    finally:
        e.stop()
    gaps = compare.served_gaps(params, model, prompt, served, "cpu")
    assert len(gaps) == 20 and max(gaps) < 1e-4


def test_controls_are_coarser_than_the_reference():
    _, model = config("gpt2-small")
    params = weights.make(model, 9, "cpu")
    toks = torch.randint(0, model["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = lm.logits(params, toks, model)
        for quant in ("fp8", "int4"):
            low = lm.logits(params, toks, model, quant)
            assert 0 < (low - ref).abs().max() < ref.abs().max()
    w = torch.randn(16, 8)
    q = lm.int4_columns(w)
    assert len(torch.unique(q[:, 0])) <= 15
    x = torch.randn(1, 20, 2, 4)
    assert lm.int4_pages(x).shape == x.shape


def test_reference_imports_nothing_of_the_program():
    for f in (ROOT / "h100bench/reference").glob("*.py"):
        text = f.read_text()
        assert "deeplearning4j_tpu" not in text.replace(
            "imports nothing of ``deeplearning4j_tpu_torch``", ""), f.name
        assert "import jax" not in text


def test_config_replace_keeps_fields():
    cfg, model = config("bert-base")
    _, pcfg = port(model, cfg["train"])
    assert dataclasses.replace(pcfg).attention == "flash"
    assert pcfg.causal is False and pcfg.remat is False
