"""The port's serving smoke tool against the reference's
(``tools/serving_smoke.py``), on the CPU.

Same draws and same tokens: the default leg and the prefix leg run in
both packages with one client thread, recording every request the
client sends and every answer; the port runs on the reference's weights
(``model.init(jax.random.key(7))`` carried over as numpy), so the plans
must be equal and every greedy answer equal token for token.  Same keys:
each leg's JSON result holds every key the reference's leg writes (read
from the reference's source).  Then the legs' own assertions at the
tools' own size (the trace chain under lockguard, the quantized prefix
leg, the SLO windows) and the device rule of the CLI.  The fleet,
router, autoscale, disaggregated and online legs are in
``test_torch_serving_smoke_legs.py``.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JLM)
from deeplearning4j_tpu.serving import ServingClient as JClient
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.serving import ServingClient as TClient
from deeplearning4j_tpu_torch.tools import serving_smoke as ss
from torch_port_obs import port_obs  # noqa: F401  (autouse)

from tools import serving_smoke as jss

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models: torch's intra-op threads only spin (and slow the
    other test workers); one thread for this module, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: keys a reference leg writes only when asked (``--lockguard``,
#: ``--trace-out``)
OPTIONAL = frozenset({"lockguard_violations", "trace"})


def reference_keys(path: Path, fn: str, optional=OPTIONAL) -> set[str]:
    """The string keys a function of the reference tool writes into its
    result: the ``result = {...}`` (or returned) dict literal and every
    ``result["key"] = ...`` after it, but for ``optional``."""
    tree = ast.parse(path.read_text())
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == fn)
    keys: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "result"
                for t in n.targets) and isinstance(n.value, ast.Dict):
            keys |= {k.value for k in n.value.keys
                     if isinstance(k, ast.Constant)}
        elif isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                and t.value.id == "result" for t in n.targets):
            sl = n.targets[0].slice
            if isinstance(sl, ast.Constant):
                keys.add(sl.value)
        elif isinstance(n, ast.Return) and isinstance(n.value, ast.Dict) \
                and n in node.body:
            keys |= {k.value for k in n.value.keys
                     if isinstance(k, ast.Constant)}
    assert keys, fn
    return keys - set(optional)


def carry_reference_weights(monkeypatch):
    """The port's legs draw the reference's weights: ``model.init(
    jax.random.key(seed))`` at the leg's config, through numpy."""
    def init(model, seed):
        c = model.cfg
        jcfg = JConfig(vocab_size=c.vocab_size, d_model=c.d_model,
                       n_heads=c.n_heads, n_layers=c.n_layers, d_ff=c.d_ff,
                       max_len=c.max_len, dtype=jnp.float32, remat=False,
                       xent_chunk=c.xent_chunk)
        jp = JLM(jcfg).init(jax.random.key(seed))
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device=model.device)

    monkeypatch.setattr(ss, "_init_params", init)


def record_generate(monkeypatch, cls) -> list:
    """Every ``cls.generate(**plan)`` call's plan and answer tokens."""
    calls = []
    orig = cls.generate

    def generate(self, *args, **kw):
        out = orig(self, *args, **kw)
        calls.append((dict(kw), list(out["tokens"])))
        return out

    monkeypatch.setattr(cls, "generate", generate)
    return calls


def greedy_agree(ref_calls, port_calls) -> int:
    """Plans equal in order; greedy answers equal; their count."""
    assert [p for p, _ in port_calls] == [p for p, _ in ref_calls]
    greedy = [(a, b) for (p, a), (_, b) in zip(ref_calls, port_calls)
              if p["temperature"] == 0.0]
    assert [b for _, b in greedy] == [a for a, _ in greedy]
    return len(greedy)


@pytest.mark.parametrize("leg,kw", [
    ("run", dict(requests=8, threads=1, seed=3)),
    ("run_prefix", dict(requests=8, threads=1, seed=3)),
])
def test_same_draws_and_greedy_tokens_as_the_reference(monkeypatch, leg, kw):
    ref_calls = record_generate(monkeypatch, JClient)
    ref = getattr(jss, leg)(**kw)
    carry_reference_weights(monkeypatch)
    port_calls = record_generate(monkeypatch, TClient)
    got = getattr(ss, leg)(**kw, device=CPU)
    assert len(ref_calls) == len(port_calls) == kw["requests"]
    assert greedy_agree(ref_calls, port_calls) > 0
    assert got["completed"] == ref["completed"] == kw["requests"]
    assert set(ref) <= set(got)


@pytest.mark.parametrize("leg", ["run", "run_prefix", "run_disagg",
                                 "run_replicas", "run_slo", "run_online",
                                 "run_fleet", "run_autoscale"])
def test_legs_keep_the_reference_signature(leg):
    """Same name, keywords and defaults (the port adds ``cfg``, ``device``
    and, on the legs ``chip_smoke.py`` drives at full width, ``serving``
    after them, keyword-only; ``run_disagg`` also ``page_size``, whose
    default is the page size the reference's leg fixes)."""
    import inspect

    ref = inspect.signature(getattr(jss, leg)).parameters
    got = inspect.signature(getattr(ss, leg)).parameters
    assert [(n, p.default) for n, p in got.items()][:len(ref)] == \
        [(n, p.default) for n, p in ref.items()]
    extra = list(got)[len(ref):]
    assert set(extra) <= {"cfg", "serving", "device", "page_size"}
    assert "device" in extra
    if "page_size" in extra:
        assert leg == "run_disagg" and got["page_size"].default == 8
    assert all(got[n].kind is inspect.Parameter.KEYWORD_ONLY for n in extra)


def test_serving_overrides_refuse_page_size():
    """A leg sizes its prompts in its own pages: ``serving`` lays engine
    fields over the leg's config but may not move its page size."""
    from deeplearning4j_tpu_torch.serving import ServingConfig

    base = ServingConfig(paged=True, page_size=6, kv_quant="int8")
    got = ss._serving_cfg(base, {"slots": 8,
                                 "paged_attention_impl": "pallas"})
    assert (got.slots, got.page_size) == (8, 6)
    assert got.paged_attention_impl == "pallas_int8"
    with pytest.raises(ValueError, match="page_size"):
        ss._serving_cfg(base, {"page_size": 16})


def test_zipf_plans_match_the_reference_draws():
    """The shared Zipf draw, against the reference's inline draw code."""
    import random

    for seed in range(5):
        for sys_len in (8, 24):
            rng = random.Random(seed)
            sys_prompts = [[rng.randrange(64) for _ in range(sys_len)]
                           for _ in range(6)]
            zipf_w = [1.0 / (r + 1) ** 1.5 for r in range(6)]
            want = []
            for _ in range(12):
                tenant = rng.choices(range(6), weights=zipf_w)[0]
                user = [rng.randrange(64) for _ in range(rng.randint(1, 5))]
                want.append(dict(prompt=sys_prompts[tenant] + user,
                                 max_new_tokens=rng.randint(1, 8),
                                 temperature=rng.choice([0.0, 0.7]),
                                 seed=rng.randrange(1 << 20)))
            assert ss._zipf_plans(random.Random(seed), 64, 12, sys_len) \
                == want


def test_trace_chain_under_lockguard(tmp_path):
    """``--trace-out`` under ``--lockguard``: every request's full span
    chain under one trace id, no lock violation, and the merged file
    reads through ``tools/trace_report.py``."""
    from tools.trace_report import load_events, request_breakdowns

    path = tmp_path / "trace.json"
    out = ss.run(requests=12, threads=3, seed=1, lockguard=True,
                 trace_out=str(path), device=CPU)
    assert out["lockguard_violations"] == 0 and not out["failures"]
    assert reference_keys(ROOT / "tools" / "serving_smoke.py", "run",
                          optional=()) <= set(out)
    assert out["trace"]["requests_traced"] == 12
    events, dropped = load_events(path)
    rows = request_breakdowns(events)
    assert len(rows) >= 12 and dropped == out["trace"]["dropped"]
    assert all(r["prefill_ms"] is not None for r in rows)
    assert json.loads(path.read_text())["metadata"]["sources"] == [str(path)]


def test_prefix_leg_quantized_kv():
    out = ss.run_prefix(kv_quant="int8", device=CPU)
    assert out["kv_bytes_per_slot_shrink"] >= 1.9
    assert out["greedy_token_agreement"] >= 0.999
    assert out["greedy_top2_margin"]["positions"] \
        == out["greedy_tokens_compared"]
    assert set(reference_keys(ROOT / "tools" / "serving_smoke.py",
                              "run_prefix")) <= set(out)


def test_slo_leg_reaches_a_full_window():
    out = ss.run_slo(requests=24, window_s=1.0, device=CPU)
    assert out["full_window_objectives"] and out["burn_rates"]
    assert set(reference_keys(ROOT / "tools" / "serving_smoke.py",
                              "run_slo")) <= set(out)


def test_cli_raises_without_a_card_unless_cpu_is_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ss.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        ss.main(["--prefix-workload", "--platform", "cuda"])
    assert ss.main(["--platform", "cpu", "--requests", "4",
                    "--threads", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["completed"] == 4
