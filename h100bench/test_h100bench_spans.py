"""The six span metrics (``metrics/train_fwd_ms.py`` and the five that
call its ``per_step_ms``) on whole CPU rehearsals (``tools/rehearse.py``)
of both training cells: each reads a finite positive number, the kernels'
backwards fit inside the backward, and each reads None when the program's
observability is off for the run.  The rehearsal's batch is raised so the
loss takes the blocked xent (it does above ``xent_chunk``'s 2048 tokens,
as the cells' 32,768 and 65,536 do)."""

import math

import pytest

from h100bench.tools import rehearse

TRAINS = ("bert-base.train-64x512", "gpt2-small.train-64x1024")
SEED = 2 ** 31 + 77
SPAN_METRICS = ("train_fwd_ms", "train_bwd_ms", "train_opt_ms",
                "attention_bwd_ms", "xent_bwd_ms", "layernorm_bwd_ms")
#: sequences a step in the rehearsal: over 2048 tokens at its lengths
BATCH = {"bert-base.train-64x512": 17, "gpt2-small.train-64x1024": 9}


def run(cell, disable=False):
    from deeplearning4j_tpu_torch import observability as obs

    def hook(ctx):
        ctx.cell.traffic["batch"] = BATCH[cell]
        if disable:
            obs.disable()

    try:
        return rehearse.rehearse(cell, SEED, 1.0, True, setup_hook=hook)
    finally:
        obs.enable()


@pytest.mark.parametrize("cell", TRAINS)
def test_span_metrics_read_the_window_steps(cell):
    res = run(cell)
    assert res["correct"], res["compared"]
    got = {m: res["metrics"][m]["value"] for m in SPAN_METRICS}
    for name, value in got.items():
        assert math.isfinite(value) and value > 0, name
        assert res["metrics"][name]["unit"] == "ms"
    kernels = got["attention_bwd_ms"] + got["xent_bwd_ms"] + \
        got["layernorm_bwd_ms"]
    assert kernels <= got["train_bwd_ms"]


@pytest.mark.parametrize("cell", TRAINS)
def test_span_metrics_read_none_with_observability_off(cell):
    res = run(cell, disable=True)
    assert res["correct"], res["compared"]
    for name in SPAN_METRICS:
        assert name not in res["metrics"], name
    assert "train_mfu" in res["metrics"]
