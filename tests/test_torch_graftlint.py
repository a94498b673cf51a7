"""graftlint for the port (``deeplearning4j_tpu_torch/analysis/``): the
rule set for torch code, pragmas, baseline and CLI.

The port keeps every reference rule whose hazard carries over to torch
code (RC01, DON01, SH03 and SH04 have none: see ``rules.py``).  The
rules ported as they are give, on the same sources through both
packages' analyzers, the same ``(rule, line, col)`` set; the rules
rewritten for torch code are held on positive and negative snippets.
The pragma syntax and the baseline file format are the reference's: a
baseline either package writes, the other reads.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from deeplearning4j_tpu.analysis import Analyzer as JAnalyzer
from deeplearning4j_tpu.analysis import Baseline as JBaseline
from deeplearning4j_tpu.analysis import all_rules as j_all_rules
from deeplearning4j_tpu_torch.analysis import (SUPPRESSED, Analyzer,
                                               Baseline, active, all_rules,
                                               summarize, to_json, to_text)
from deeplearning4j_tpu_torch.analysis.__main__ import main

ROOT = Path(__file__).resolve().parents[1]
DROPPED = {"RC01", "DON01", "SH03", "SH04"}
AS_IS = ["EXC01", "LK01", "LK02", "TH01", "PG01", "OB02", "OB03", "OL01",
         "CT01", "DG01"]


def test_the_rule_set_is_the_reference_s_less_the_dropped_four():
    assert set(all_rules()) == set(j_all_rules()) - DROPPED
    assert len(all_rules()) == 23
    for rule in all_rules().values():
        assert rule.title and rule.__doc__


def _findings(analyzer_cls, rules, paths):
    a = analyzer_cls(rules=rules, root=str(ROOT))
    return a, a.analyze_paths([str(ROOT / p) for p in paths])


#: the modules the as-is rules look at (serving, pages, control, online,
#: checkpoints, fleet labels), in both packages
PARITY_PATHS = [f"{pkg}/{rel}" for pkg in ("deeplearning4j_tpu",
                                           "deeplearning4j_tpu_torch")
                for rel in ("serving", "control", "online",
                            "parallel/checkpoint.py", "parallel/scaleout.py",
                            "observability/fleet.py",
                            "resilience/supervisor.py")]


@pytest.fixture(scope="module")
def parity():
    port = [all_rules()[r] for r in AS_IS]
    ref = [j_all_rules()[r] for r in AS_IS]
    _, got = _findings(Analyzer, port, PARITY_PATHS)
    _, want = _findings(JAnalyzer, ref, PARITY_PATHS)
    return got, want


@pytest.mark.parametrize("rule", AS_IS)
def test_as_is_rules_match_the_reference_on_the_same_sources(parity, rule):
    got, want = parity
    key = (lambda f: (f.path, f.line, f.col, f.status))
    assert sorted(key(f) for f in got if f.rule == rule) == sorted(
        key(f) for f in want if f.rule == rule)


def _check(rule, src, path="deeplearning4j_tpu_torch/serving/x.py"):
    a = Analyzer(rules=[all_rules()[rule]])
    return [f.line for f in a.analyze_source(src, path)]


CASES = {
    # ------------------------------------------------------------ HS01
    "HS01 item in a loop": ("HS01", '''
def run(step, xs):
    out = []
    for x in xs:
        loss = step._step(x)
        out.append(loss.item())
    return out
''', [6]),
    "HS01 loop-free per-call": ("HS01", '''
import torch
def once(n, dev):
    t = torch.zeros(n, device=dev)
    return float(t.sum())
''', [5]),
    "HS01 the fence after the loop": ("HS01", '''
def run(step, xs):
    out = []
    for x in xs:
        loss = step._step(x)
        out.append(loss)
    return [v.item() for v in out]
''', []),
    "HS01 under allow_transfers": ("HS01", '''
from deeplearning4j_tpu_torch.analysis.runtime import allow_transfers
def run(step, xs):
    for x in xs:
        loss = step._step(x)
        with allow_transfers():
            print(loss.cpu())
''', []),
    "HS01 in a function allow_transfers decorates": ("HS01", '''
from deeplearning4j_tpu_torch.analysis.runtime import allow_transfers
@allow_transfers()
def pull(step, x):
    return step._step(x).cpu()
''', []),
    "HS01 a kernel wrapper's result": ("HS01", '''
from deeplearning4j_tpu_torch.ops.cuda import xent
def run(h, w, ys):
    for y in ys:
        loss = xent.blocked_xent(h, w, y)
        print(loss.tolist())
''', [6]),
    "HS01 direct form": ("HS01", '''
def per_call(self, x):
    return float(self._step_fn(x))
''', []),
    "HS01 direct form of a built step": ("HS01", '''
class T:
    def __init__(self):
        self._step_fn = self._build_sync_step()
    def per_call(self, x):
        return float(self._step_fn(x))
''', [6]),
    # ----------------------------------------------------------- RNG01
    "RNG01 two generators from one seed": ("RNG01", '''
import torch
def draws(seed):
    a = torch.Generator().manual_seed(seed)
    b = torch.Generator().manual_seed(seed)
    return a, b
''', [5]),
    "RNG01 reseeding every iteration": ("RNG01", '''
from deeplearning4j_tpu_torch.ops.rng import key_for
def loop(seed, n):
    for _ in range(n):
        g = key_for(seed)
''', [5]),
    "RNG01 a rebound seed": ("RNG01", '''
import torch
def ok(seed, batch):
    g = torch.Generator().manual_seed(seed)
    seed = seed + 1
    h = torch.Generator().manual_seed(seed)
    for p in batch:
        req = p.request
        torch.Generator().manual_seed(req.seed)
''', []),
    "RNG01 drawing twice from one generator": ("RNG01", '''
import torch
def ok(gen):
    a = torch.rand(3, generator=gen)
    b = torch.rand(3, generator=gen)
''', []),
    # ------------------------------------------------------------ TB01
    "TB01 if on a device tensor in a loop": ("TB01", '''
def run(model, xs):
    for x in xs:
        done = model._step(x)
        if done:
            break
        while done.any() and x is not None:
            pass
''', [5, 7]),
    "TB01 host-held attributes and explicit reads": ("TB01", '''
def run(model, xs):
    for x in xs:
        y = model._step(x)
        if y.shape[0] > 2 or y.device.type == "cuda" or y is None:
            pass
        if int(y.sum()) > 0:
            pass
''', []),
    # ----------------------------------------------------------- HOT02
    "HOT02 an uninstrumented kernel loop": ("HOT02", '''
from deeplearning4j_tpu_torch.ops.cuda import attention
def run(qs):
    for q in qs:
        attention.flash_attention(q, q, q)
''', [4]),
    "HOT02 a span in reach": ("HOT02", '''
from deeplearning4j_tpu_torch.observability import METRICS
from deeplearning4j_tpu_torch.ops.cuda import attention
def run(qs):
    for q in qs:
        attention.flash_attention(q, q, q)
    METRICS.increment("x.steps")
''', []),
    # ------------------------------------------------------------ PL01
    "PL01 a CUDA candidate without its plain version": ("PL01", '''
from . import build, registry
def kern(x):
    return build.function("k", "dl4j_k", [])(x)
registry.register(registry.KernelCandidate(kind="k", name="cuda", fn=kern))
registry.register(registry.KernelCandidate(kind="k", name="c2", fn=kern,
                                           reference=None, source="cuda"))
''', [4, 5, 6]),
    "PL01 with its plain version": ("PL01", '''
from . import build, registry
def kern(x):
    return build.function("k", "dl4j_k", [])(x)
def plain(x):
    return x
registry.register(registry.KernelCandidate(kind="k", name="cuda", fn=kern,
                                           reference=plain))
registry.register(registry.KernelCandidate(kind="k", name="gather",
                                           fn=plain, source="torch"))
''', []),
    # ------------------------------------------------------------ ZR01
    "ZR01 an ungated gather of the state": ("ZR01", '''
from deeplearning4j_tpu_torch.parallel import collectives as clv
from deeplearning4j_tpu_torch.utils.tree_math import tree_map
class T:
    def snapshot(self, state):
        if self.zero_stage:
            pass
        full = clv.all_gather(state.tstate, "dp")
        def whole(v):
            return clv.all_gather_or_identity(v, "dp", 2)
        return tree_map(whole, state.tstate), full
''', [8, 11]),
    "ZR01 gated, and the sanctioned save": ("ZR01", '''
from deeplearning4j_tpu_torch.parallel import collectives as clv
class T:
    def snapshot(self, state):
        if self.zero_stage == 0:
            return clv.all_gather(state.tstate, "dp")
    def checkpoint(self, state):
        if self.zero_stage >= 1:
            pass
        return clv.all_gather(state.tstate, "dp")
''', []),
    # ------------------------------------------------------------ QT01
    "QT01 raw casts in serving": ("QT01", '''
import torch
def store(x):
    a = x.to(torch.int8)
    b = x.to(dtype=torch.float8_e4m3fn)
    c = x.to("cuda", torch.int8)
    d = x.to(torch.int32)
    return a, b, c, d
''', [4, 5, 6]),
    # ------------------------------------------------------------ EL01
    "EL01 raw groups outside mesh.py": ("EL01", '''
import torch.distributed as dist
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, rank_devices
def build(n):
    g = dist.new_group([0, 1])
    dist.init_process_group("gloo")
    m = Mesh(rank_devices()[:8], ("dp",))
    ok = rank_devices()[:n]
''', [5, 6, 7, 7]),
    # ------------------------------------------------------------ NM01
    "NM01 unstable softmax and logsumexp": ("NM01", '''
import torch
def probs(x):
    e = torch.exp(x)
    return e / e.sum(-1, keepdim=True)
def lse(x):
    return torch.log(torch.exp(x).sum(-1))
def stable(x):
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(-1, keepdim=True)
''', [5, 7]),
}

PATHS = {"PL01": "deeplearning4j_tpu_torch/ops/cuda/k.py",
         "ZR01": "deeplearning4j_tpu_torch/parallel/t.py",
         "EL01": "deeplearning4j_tpu_torch/parallel/t.py",
         "NM01": "deeplearning4j_tpu_torch/ops/t.py"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_rules_on_snippets(name):
    rule, src, want = CASES[name]
    path = PATHS.get(rule, "deeplearning4j_tpu_torch/serving/x.py")
    assert _check(rule, src.lstrip("\n"), path) == [w - 1 for w in want]


@pytest.mark.parametrize("rule,path", [
    ("QT01", "deeplearning4j_tpu_torch/ops/cuda/kv_quant.py"),
    ("EL01", "deeplearning4j_tpu_torch/parallel/mesh.py"),
    ("NM01", "deeplearning4j_tpu_torch/serving/x.py")])
def test_scoped_rules_stay_in_their_trees(rule, path):
    (src_rule, src, _want), = [c for c in CASES.values() if c[0] == rule]
    assert _check(rule, src.lstrip("\n"), path) == []


# ------------------------------------------------------ pragmas + baseline
PRAGMAS = '''
def run(step, xs):
    for x in xs:
        a = step._step(x)
        a.item()  # graftlint: disable=HS01
        # graftlint: disable=HS01 — a comment-only pragma: the next line
        a.cpu()
        a.tolist()  # graftlint: disable=TB01
        a.numpy()  # graftlint: disable
'''


def test_pragmas_suppress_as_the_reference_s_do():
    fs = Analyzer(rules=[all_rules()["HS01"]]).analyze_source(
        PRAGMAS.lstrip("\n"), "x.py")
    assert [(f.line, f.status) for f in fs] == [
        (4, SUPPRESSED), (6, SUPPRESSED), (7, "active"), (8, SUPPRESSED)]
    whole = "# graftlint: disable-file=HS01\n" + PRAGMAS.lstrip("\n")
    fs = Analyzer(rules=[all_rules()["HS01"]]).analyze_source(whole, "x.py")
    assert active(fs) == [] and len(fs) == 4


def test_baseline_round_trips_in_the_reference_s_format(tmp_path):
    fs = Analyzer(rules=[all_rules()["HS01"]]).analyze_source(
        PRAGMAS.lstrip("\n"), "x.py")
    new = active(fs)
    path = tmp_path / "b.json"
    Baseline.from_findings(new).save(str(path))
    for cls in (Baseline, JBaseline):       # either package reads it
        b = cls.load(str(path))
        assert all(b.contains(f) for f in new)
    again = Analyzer(rules=[all_rules()["HS01"]],
                     baseline=Baseline.load(str(path))).analyze_source(
        PRAGMAS.lstrip("\n"), "x.py")
    assert active(again) == [] and Baseline.load(
        str(path)).stale_entries(again) == []
    # an edit to the flagged line invalidates its entry
    edited = PRAGMAS.lstrip("\n").replace("a.tolist()", "a.tolist( )")
    fs = Analyzer(rules=[all_rules()["HS01"]],
                  baseline=Baseline.load(str(path))).analyze_source(
        edited, "x.py")
    assert len(active(fs)) == 1
    assert len(Baseline.load(str(path)).stale_entries(fs)) == 1
    data = json.loads(path.read_text())
    assert data["version"] == 1 and set(data["entries"][0]) == {
        "rule", "path", "line", "code", "justification"}


def test_reports_and_summary():
    fs = Analyzer(rules=[all_rules()["HS01"]]).analyze_source(
        PRAGMAS.lstrip("\n"), "x.py")
    s = summarize(fs)
    assert (s["total"], s["active"], s["suppressed"]) == (4, 1, 3)
    assert set(s["by_rule"]) == set(all_rules())
    assert to_text(fs).count("HS01") == 1
    assert to_json(fs)["tool"] == "graftlint"


def test_unparseable_files_are_reported_not_fatal():
    a = Analyzer()
    assert a.analyze_source("def (:\n", "bad.py") == []
    assert a.skipped_files == 1 and a.errors


# ------------------------------------------------------------------ CLI
def test_cli_lists_the_rules(capsys):
    assert main(["--rules"]) == 0
    out = capsys.readouterr().out
    assert "HS01" in out and "RC01" not in out


def test_cli_check_fails_on_a_new_finding_and_passes_when_baselined(
        tmp_path, capsys):
    src = tmp_path / "deeplearning4j_tpu_torch" / "serving" / "x.py"
    src.parent.mkdir(parents=True)
    src.write_text(PRAGMAS.lstrip("\n"))
    base = tmp_path / "b.json"
    args = [str(src), "--baseline", str(base), "--no-metrics"]
    assert main(args + ["--check"]) == 1
    assert main(args + ["--write-baseline"]) == 0
    assert main(args + ["--check"]) == 0
    capsys.readouterr()
    assert main(args + ["--json", "--stale"]) == 0
    payload = json.loads(capsys.readouterr().out)
    written = json.loads(base.read_text())["entries"]
    assert payload["summary"]["active"] == 0
    assert payload["summary"]["baselined"] == len(written) >= 1
    assert all(e["justification"].startswith("TODO") for e in written)
    assert payload["stale_baseline_entries"] == []
    assert main(args + ["--rules", "NOPE"]) == 2


def test_cli_diff_narrows_to_changed_files(capsys):
    assert main(["--diff", "HEAD", "--no-metrics",
                 str(ROOT / "deeplearning4j_tpu_torch" / "analysis")]) in (0, 1)
    out = capsys.readouterr()
    assert "graftlint" in out.out + out.err
    # an unknown ref falls back to the full tree, never narrows to nothing
    assert main(["--diff", "no-such-ref-xyz", "--no-metrics", "--rules",
                 "EXC01", str(ROOT / "deeplearning4j_tpu_torch" /
                              "analysis")]) == 0
    assert "falling back" in capsys.readouterr().err


def test_the_module_runs_as_a_program():
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.analysis",
         "--rules"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "PL01" in out.stdout
