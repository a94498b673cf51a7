"""The port's runtime placement-drift detector (``deeplearning4j_tpu_torch/
analysis/shardguard.py``).

A leaf's placement is its device plus the local block shape its
``NamedSharding`` implies.  Explicit mode compares each leaf with the
declared sharding (the site's device, the global shape the block stands
for); baseline mode captures device and shape at the first call.
Representation (dtype, strides, contiguity) is never flagged.  The
trainer's and engine's wrapped steps carry the reference's site names
and run a CPU ``fit`` and a served request with no violation.  The tests
drive private ``ShardGuard`` instances where they plant violations, and
reset the process-wide one around each test.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis import shardguard as jsg
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.analysis import shardguard as sg
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.optimize import transforms as TT
from deeplearning4j_tpu_torch.parallel.mesh import DP, NamedSharding, P
from deeplearning4j_tpu_torch.parallel.trainer import DataParallelTrainer
from deeplearning4j_tpu_torch.serving import InferenceEngine, ServingConfig
from torch_port_obs import port_obs  # noqa: F401  (autouse)


class _Mesh:
    """A member's view of a dp=4 mesh (what ``global_shape`` reads)."""

    member = True

    def axis_size(self, axis):
        return 4 if axis == DP else 1

    def axis_index(self, axis):
        return 0


BATCH = NamedSharding(_Mesh(), P(DP))
REP = NamedSharding(_Mesh(), P())


@pytest.fixture
def guard():
    return sg.ShardGuard().enable()


@pytest.fixture
def global_guard():
    sg.SHARDGUARD.reset()
    sg.SHARDGUARD.enable()
    yield sg.SHARDGUARD
    sg.SHARDGUARD.disable()
    sg.SHARDGUARD.reset()


def _echo(*args):
    return args[0]


def _nothing(*args):
    return None


@pytest.mark.parametrize("value", [None, "", "1", "on", "TRUE", "yes",
                                   "enabled", "0", "off", "no"])
def test_env_switch_matches_the_reference(value, monkeypatch):
    assert sg.ENV_SHARDGUARD == jsg.ENV_SHARDGUARD
    if value is None:
        monkeypatch.delenv(sg.ENV_SHARDGUARD, raising=False)
    else:
        monkeypatch.setenv(sg.ENV_SHARDGUARD, value)
    assert sg.enabled_from_env() == jsg.enabled_from_env()


def test_explicit_mode_flags_a_leaf_on_another_device(guard):
    step = guard.wrap("t.explicit", _nothing, in_shardings=(REP, BATCH),
                      device="cpu")
    w, x = torch.ones(3, 2), torch.ones(4, 3)
    step(w, x)
    step(w, x)
    assert guard.violations() == []
    step(torch.ones(3, 2, device="meta"), x)
    (v,) = guard.violations()
    assert (v.kind, v.site) == ("resharded-input", "t.explicit")
    assert "meta" in v.message and v.details[0] == "[0]"
    # the declared device decides from the first call on
    fresh = guard.wrap("t.first", _nothing, in_shardings=(REP,),
                       device="cpu")
    fresh(torch.ones(2, device="meta"))
    assert [v.site for v in guard.violations()] == ["t.explicit", "t.first"]


def test_explicit_mode_flags_a_block_of_another_width(guard):
    """A global batch arriving where this rank's rows were declared: the
    global shape its block implies under P('dp') is 4x the site's."""
    step = guard.wrap("t.rows", _nothing, in_shardings=(BATCH,),
                      device="cpu")
    step(torch.ones(4, 3))
    step(torch.ones(16, 3))
    (v,) = guard.violations()
    assert "global shape (64, 3)" in v.message
    assert "(16, 3)" in v.message


def test_baseline_mode_captures_the_first_call_and_flags_drift(guard):
    step = guard.wrap("t.base", lambda tree, n: tree["a"] * n)
    tree = {"a": torch.ones(2, 3), "b": [torch.zeros(4)]}
    step(tree, 2)
    # dtype, strides and contiguity are representation, not placement
    step({"a": torch.ones(3, 2, dtype=torch.float64).t(),
          "b": [torch.zeros(8)[::2]]}, 3)
    assert guard.violations() == []
    step({"a": torch.ones(2, 3), "b": [torch.zeros(5)]}, 2)
    (v,) = guard.violations()
    assert v.details[0] == "[0]['b'][0]" and v.kind == "resharded-input"


def test_output_drift_is_its_own_kind(guard):
    step = guard.wrap("t.out", lambda n: torch.zeros(n))
    step(3)
    step(4)
    assert [v.kind for v in guard.violations()] == ["resharded-output"]


def test_counts_every_occurrence_and_reports_each_leaf_once(guard):
    step = guard.wrap("t.count", _echo)
    step(torch.ones(2))
    for _ in range(3):
        step(torch.ones(5))
    # one violation a leaf and direction, every occurrence counted
    assert [v.kind for v in guard.violations()] == ["resharded-input",
                                                     "resharded-output"]
    assert guard.counts() == {"resharded-input": 3, "resharded-output": 3}
    assert "2 violation" in guard.report()
    guard.reset()
    assert guard.violations() == []
    assert guard.report() == "shardguard: clean (0 violations)"


def test_disabled_guard_checks_nothing():
    g = sg.ShardGuard()
    step = g.wrap("t.off", _echo)
    step(torch.ones(2))
    step(torch.ones(7, device="meta"))
    assert g.violations() == [] and step.__wrapped__ is _echo


def test_gauges_move_on_the_metrics_registry(global_guard):
    step = global_guard.wrap("t.gauge", _echo)
    step(torch.ones(2))
    step(torch.ones(3))
    global_guard.emit_metrics()
    gauges = tobs.METRICS.snapshot()["gauges"]
    assert gauges["shardguard.violations.resharded_input"] == 1
    assert gauges["shardguard.violations.resharded_output"] == 1


def test_active_context_enables_and_disables():
    g = sg.ShardGuard()
    with sg.shardguard_active(g) as active:
        assert active is g and g.enabled
    assert not g.enabled


# ------------------------------------------------------- trainer and engine
def _data():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(6, 1))
    out = []
    for n in (16, 16, 9, 16):
        x = rng.normal(size=(n, 6)).astype(np.float32)
        out.append(DataSet(x, (x @ w).astype(np.float32)))
    return {"w": np.zeros((6, 1), np.float32),
            "b": np.zeros((1,), np.float32)}, out


def _loss(p, x, y, gen=None):
    return ((x @ p["w"] + p["b"] - y) ** 2).mean()


@pytest.mark.parametrize("zero_stage,site", [(0, "train.sync_step"),
                                             (1, "train.zero_step"),
                                             (3, "train.zero_step")])
def test_fit_has_no_violation_and_the_sites_carry_the_reference_names(
        global_guard, zero_stage, site):
    params, data = _data()
    trainer = DataParallelTrainer(_loss, TT.sgd_lr(0.05), device="cpu",
                                  zero_stage=zero_stage)
    state, losses = trainer.fit(trainer.init_state(params), data)
    assert all(np.isfinite(losses)) and global_guard.violations() == []
    # a parameter arriving on another device is counted at that site
    # (checked before the call; the step itself then fails on it)
    step = trainer._step_for(16)
    bad = dict(state.params)
    bad["w"] = torch.empty_like(bad["w"], device="meta")
    gen = torch.Generator().manual_seed(0)
    x, y = (torch.as_tensor(data[0].features),
            torch.as_tensor(data[0].labels))
    with pytest.raises(Exception):
        step(bad, state.tstate, x, y, gen, state.step, 16)
    (v,) = global_guard.violations()
    assert (v.kind, v.site) == ("resharded-input", site)
    global_guard.emit_metrics()
    assert tobs.METRICS.snapshot()["gauges"][
        "shardguard.violations.resharded_input"] == 1


@pytest.mark.parametrize("spec", [False, True])
def test_served_requests_have_no_violation(global_guard, spec):
    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_len=32)
    model = ttr.TransformerLM(ttr.TransformerConfig(**kw), device="cpu")
    params = model.init()
    extra = {}
    if spec:
        from deeplearning4j_tpu_torch.models import zoo
        dm, dp = zoo.draft_lm(model.cfg, device="cpu")
        extra = dict(draft_model=dm, draft_params=dp)
    cfg = ServingConfig(slots=2, resolve_every=2, speculative=spec, spec_k=2)
    with InferenceEngine(model, params, cfg=cfg, device="cpu",
                         **extra) as engine:
        engine.generate([1, 2, 3], 5, timeout=120)
        engine.set_speculative(False)
        engine.generate([4, 5], 4, timeout=120)
        sites = {engine._step_fn.__name__, getattr(
            engine._plain_step_fn, "__name__", None)}
    assert global_guard.violations() == []
    assert sites == ({"_spec_step", "_step"} if spec else {"_step", None})
