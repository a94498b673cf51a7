"""The port's static concurrency model (``deeplearning4j_tpu_torch/
analysis/concurrency.py``, a copy) against the reference's.

On the same files — the threaded modules of both packages (serving
engine and batcher, router, scaleout, the HTTP servers, prefetch,
supervision) — the port's ``module_concurrency`` gives the reference's
classes, per-attribute writes with their held locks, ``guarded-by``
contracts, thread contexts, lock-order edges and blocking calls, and
``find_cycles`` the same cycles.  Blocking calls differ only where the
packages' device fences do (``torch.cuda.synchronize``/
``.synchronize()`` in the port, ``block_until_ready``/
``jax.device_get`` in the reference); the snippet test shows each.  LK01-
LK03 and TH01 then give the same findings through both analyzers.
"""

import ast
from pathlib import Path

import pytest

from deeplearning4j_tpu.analysis import concurrency as jcc
from deeplearning4j_tpu.analysis import jitinfo as jji
from deeplearning4j_tpu.analysis import rules as jrules  # noqa: F401
from deeplearning4j_tpu.analysis.core import all_rules as j_all_rules
from deeplearning4j_tpu_torch.analysis import concurrency as tcc
from deeplearning4j_tpu_torch.analysis import jitinfo as tji
from deeplearning4j_tpu_torch.analysis.core import all_rules as t_all_rules

ROOT = Path(__file__).resolve().parents[1]
FILES = [f"{pkg}/{rel}" for pkg in ("deeplearning4j_tpu",
                                     "deeplearning4j_tpu_torch")
         for rel in ("serving/engine.py", "serving/batcher.py",
                     "serving/server.py", "serving/router/router.py",
                     "serving/router/replicas.py", "parallel/scaleout.py",
                     "datasets/iterator.py", "resilience/supervisor.py",
                     "observability/metrics.py",
                     "serving/disagg/scheduler.py")]


_INFOS: dict = {}


def _info(ji, path):
    """One parsed ModuleInfo a package and file (the models memoize on
    it), shared by every test of this file."""
    key = (ji.__name__, path)
    if key not in _INFOS:
        src = SNIPPET if path == "w.py" else (ROOT / path).read_text()
        _INFOS[key] = ji.ModuleInfo(path, src)
    return _INFOS[key]


def _model(cc, ji, path):
    return cc.module_concurrency(_info(ji, path))


def _facts(model, cc):
    classes = {}
    for cls in model.classes:
        writes = {attr: sorted((w.method, w.node.lineno,
                                tuple(sorted(w.held))) for w in ws)
                  for attr, ws in cls.writes.items()}
        classes[cls.name] = dict(
            writes=writes, guarded_by=dict(cls.guarded_by),
            lock_attrs=dict(cls.lock_attrs), threaded=cls.threaded,
            contexts={m: sorted(cls.contexts(m)) for m in cls.methods})
    edges = sorted((e.held, e.acquired, e.node.lineno, e.func)
                   for e in model.edges)
    cycles = sorted([(c.held, c.acquired) for c in cyc]
                    for cyc in cc.find_cycles(model.edges))
    return classes, edges, cycles


@pytest.mark.parametrize("path", FILES)
def test_the_model_equals_the_reference_on_the_same_file(path):
    port, ref = _model(tcc, tji, path), _model(jcc, jji, path)
    assert _facts(port, tcc) == _facts(ref, jcc)
    fences = ("device fence",)
    assert [(n.lineno, why, f) for n, why, f in port.blocking
            if not why.startswith(fences)] == [
        (n.lineno, why, f) for n, why, f in ref.blocking
        if not why.startswith(fences)]


SNIPPET = '''
import threading
import time
import torch
import jax


class Worker:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self._count = 0  # guarded-by: self._a

    def one(self):
        with self._a:
            with self._b:
                self._count += 1

    def two(self):
        with self._b:
            with self._a:
                pass

    def bump(self):
        self._count += 1

    def fence(self, x):
        with self._a:
            torch.cuda.synchronize()
            x.block_until_ready()
            jax.device_get(x)
            time.sleep(0.1)


def spawn():
    threading.Thread(target=print).start()
'''


def test_cycles_and_fences_on_a_snippet():
    port, ref = _model(tcc, tji, "w.py"), _model(jcc, jji, "w.py")
    assert _facts(port, tcc)[2] == _facts(ref, jcc)[2] == [
        [("Worker._a", "Worker._b"), ("Worker._b", "Worker._a")]]
    why = {n.lineno: w for n, w, _f in port.blocking}
    rwhy = {n.lineno: w for n, w, _f in ref.blocking}
    assert why == {29: "device fence (torch.cuda.synchronize)",
                   32: "time.sleep under lock (convoy)"}
    assert rwhy == {30: "device fence (block_until_ready)",
                    31: "device fence (jax.device_get)",
                    32: "time.sleep under lock (convoy)"}


@pytest.mark.parametrize("rule", ["LK01", "LK02", "LK03", "TH01"])
def test_the_rules_agree_with_the_reference(rule):
    """On the snippet (apart from the fence lines) and on every file
    above, each concurrency rule's findings are the reference's."""
    t_rule, j_rule = t_all_rules()[rule], j_all_rules()[rule]
    for path in FILES + ["w.py"]:
        got = {(f.line, f.col) for f in t_rule.check(_info(tji, path))}
        want = {(f.line, f.col) for f in j_rule.check(_info(jji, path))}
        if rule == "LK03":
            fences = {n.lineno for n, w, _f in
                      _model(tcc, tji, path).blocking
                      + _model(jcc, jji, path).blocking
                      if w.startswith("device fence")}
            got = {g for g in got if g[0] not in fences}
            want = {w for w in want if w[0] not in fences}
        assert got == want, path
    assert ast.parse(SNIPPET)
