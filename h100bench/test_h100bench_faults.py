"""Whole runs on the CPU at a small size (``tools/rehearse.py``), past
the harness's look for the card: a sound run is ``correct``, and a run
whose timed path is broken underneath is not, once for each fault the
cell can have; the control (the reference one step of precision lower)
fails a number too."""

import pytest
import torch

from h100bench.core import train, weights
from h100bench.reference import compare
from h100bench.tools import rehearse

TRAINS = ("bert-base.train-64x512", "gpt2-small.train-64x1024")
SERVE = "gpt2-small.serve-int8-decode32"
SEED = 2 ** 31 + 99


def broken_step(monkeypatch, wrap):
    """Make ``build_train_step`` return ``wrap(step)``."""
    from deeplearning4j_tpu_torch.models import transformer as ttr

    build = ttr.TransformerLM.build_train_step

    def patched(self, *a, **kw):
        return wrap(build(self, *a, **kw))

    monkeypatch.setattr(ttr.TransformerLM, "build_train_step", patched)


@pytest.mark.parametrize("cell", TRAINS)
def test_sound_train_run_is_correct(cell):
    res = rehearse.rehearse(cell, SEED, 1.0, False)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("cell", TRAINS)
def test_train_step_that_returns_its_state_unchanged(monkeypatch, cell):
    def wrap(step):
        def still(params, opt, *data):
            _, _, loss = step(params, opt, *data)
            return params, opt, loss
        return still

    broken_step(monkeypatch, wrap)
    res = rehearse.rehearse(cell, SEED, 1.0, False)
    assert not res["correct"]
    assert res["compared"]["change"]["value"] > 0.5


@pytest.mark.parametrize("cell", TRAINS)
def test_train_step_that_leaves_out_half_the_batch(monkeypatch, cell):
    def wrap(step):
        def half(params, opt, tokens, targets):
            n = tokens.shape[0] // 2
            return step(params, opt, tokens[:n], targets[:n])
        return half

    broken_step(monkeypatch, wrap)
    res = rehearse.rehearse(cell, SEED, 1.0, False)
    assert not res["correct"]
    c = res["compared"]
    assert c["grad"]["value"] > c["grad"]["limit"]


@pytest.mark.parametrize("cell", TRAINS)
def test_train_step_whose_loss_is_altered(monkeypatch, cell):
    def wrap(step):
        def off(params, opt, *data):
            p, o, loss = step(params, opt, *data)
            return p, o, loss * 1.01
        return off

    broken_step(monkeypatch, wrap)
    res = rehearse.rehearse(cell, SEED, 1.0, False)
    assert not res["correct"]
    assert res["compared"]["loss"]["value"] > res["compared"]["loss"]["limit"]


def engine_hook(monkeypatch, patch):
    """Run ``patch(engine)`` on the engine the driver builds."""
    def hook(ctx):
        ctx.engine_hooks.append(patch)
    return hook


def test_sound_serve_run_is_correct():
    res = rehearse.rehearse(SERVE, SEED, 3.0, False)
    assert res["correct"], (res["compared"], res["notes"])
    assert res["failed"] == 0 and res["attempted"] > 0


def test_served_token_altered_where_it_is_produced(monkeypatch):
    def patch(engine):
        picks, calls = engine._picks, [0]

        def altered(logits, sampled, st):
            out = picks(logits, sampled, st)
            calls[0] += 1
            if calls[0] % 5 == 0:       # every row, every fifth step
                out = (out + 1) % logits.shape[-1]
            return out
        engine._picks = altered

    res = rehearse.rehearse(SERVE, SEED, 3.0, False,
                            setup_hook=engine_hook(monkeypatch, patch))
    assert not res["correct"]
    c = res["compared"]["token_gap"]
    assert c["value"] > c["limit"]


def test_half_the_slots_left_out(monkeypatch):
    def patch(engine):
        step = engine._step
        half = engine.cfg.slots // 2

        def half_step(params, sampled, st):
            emitted = step(params, sampled, st)
            emitted[half:] = -1
            return emitted
        engine._step = half_step
        engine._step_fn = half_step

    res = rehearse.rehearse(SERVE, SEED, 2.0, False,
                            setup_hook=engine_hook(monkeypatch, patch))
    assert not res["correct"]
    assert res["failed"] > 0


def test_decode_step_that_leaves_the_cache_unchanged(monkeypatch):
    from deeplearning4j_tpu_torch.models import transformer as ttr

    scatter = ttr._scatter_paged

    def no_decode_write(c, flat, k, v, put):
        if put is ttr._put_rows:        # the decode step's own write
            return c
        return scatter(c, flat, k, v, put)

    monkeypatch.setattr(ttr, "_scatter_paged", no_decode_write)
    res = rehearse.rehearse(SERVE, SEED, 3.0, False)
    assert not res["correct"]
    c = res["compared"]["token_gap"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("cell", TRAINS)
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_train_control_fails_a_number(seed, cell):
    """The fp8 reference in the program's place, against the float32
    reference, at the small size."""
    from h100bench.core import manifest, peaks, traffic
    from h100bench.core.context import RunContext
    from h100bench.core.model import model_of
    from h100bench.run import merge

    name = cell
    cell = manifest.load_cell(name)
    for key, extra in rehearse.overrides(name).items():
        setattr(cell, key, merge(getattr(cell, key), extra))
    ctx = RunContext(cell=cell, model=model_of(cell.config),
                     settings=cell.settings(), device="cpu",
                     peaks=peaks.REHEARSAL, seed=seed, seconds=1, trace=False)
    batches = traffic.train_batches(cell.traffic, ctx.model["vocab_size"],
                                    seed, "cpu")
    ref = train.reference_record(ctx, seed, batches)
    ctl = train.reference_record(ctx, seed, batches, quant="fp8")
    got = compare.train_readings(ctl, ref)
    limits = rehearse.LIMITS[name]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_serve_control_fails_its_number(seed):
    """The int4 reference's first choice at each position of greedy
    tokens the float32 reference itself served."""
    import json
    from pathlib import Path

    from h100bench.core.model import model_of
    from h100bench.reference import lm

    root = Path(__file__).resolve().parent
    cfg = json.loads((root / "configs/gpt2-small.json").read_text())
    small = rehearse.SMALL[SERVE]["config"]
    model = model_of({**cfg, **{k: v for k, v in small.items()
                                if not isinstance(v, dict)}})
    params = weights.make(model, seed, "cpu")
    prompt = torch.randint(0, 500, (8,), generator=torch.Generator()
                           .manual_seed(seed % 2 ** 31)).tolist()
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(40):
            seq.append(int(lm.logits(params, torch.tensor([seq]),
                                     model)[0, -1].argmax()))
    served = seq[len(prompt):]
    sound = compare.served_gaps(params, model, prompt, served, "cpu")
    ctl = compare.served_gaps(params, model, prompt, served, "cpu",
                              quant="int4")
    limit = rehearse.LIMITS[SERVE]["token_gap"]
    assert max(sound) <= limit < max(ctl)
