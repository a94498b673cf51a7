"""The port's runtime race detector (``deeplearning4j_tpu_torch/analysis/
lockguard.py``) against the reference's.

The reference's scenarios — a lock-order inversion (reported without
deadlocking, once), a consistent order, RLock re-entry, a Condition
wait, an unguarded shared write, a consistently locked one, exclusive
writes — give the same violation kinds under each package's guard.  Both
patch ``threading.Lock``/``RLock`` process-wide, so each scenario runs
under one guard, then under the other, never under both: the port's
guard refuses to install over the reference's, and the reverse order
restores what was there.  Then the port's engine serves under the
port's guard with its object under Eraser watch, with no violation.
"""

import threading
import time

import pytest

from deeplearning4j_tpu.analysis import lockguard as jlg
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.analysis import lockguard as lg
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.serving import InferenceEngine, ServingConfig
from torch_port_obs import port_obs  # noqa: F401  (autouse)


def _run(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(5.0)
    assert not t.is_alive()


def _inversion():
    a, b = threading.Lock(), threading.Lock()

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    for _ in range(2):
        _run(ab)
        _run(ba)


def _consistent_order():
    a, b = threading.Lock(), threading.Lock()

    def ab():
        with a:
            with b:
                pass

    _run(ab)
    _run(ab)


def _rlock_reentry():
    r = threading.RLock()
    with r:
        with r:
            pass


def _condition_wait():
    cv = threading.Condition()
    done = threading.Event()

    def waiter():
        with cv:
            cv.wait(0.2)
        done.set()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        cv.notify_all()
    t.join(2)
    lock = threading.Lock()
    with cv:
        with lock:
            pass


class _Box:
    def __init__(self):
        self.lock = threading.Lock()
        self.n = 0


def _writes(guard, locked: bool, threads: int):
    box = _Box()
    guard.watch(box)

    def bump():
        for _ in range(3):
            if locked:
                with box.lock:
                    box.n += 1
            else:
                box.n += 1

    # the first writer is this thread, alive throughout: an exited
    # thread's ident may be reused by the next one, which the lockset
    # would take for the same owner
    bump()
    for _ in range(threads - 1):
        _run(bump)
    guard.unwatch(box)


SCENARIOS = {
    "inversion": lambda g: _inversion(),
    "consistent order": lambda g: _consistent_order(),
    "rlock re-entry": lambda g: _rlock_reentry(),
    "condition wait": lambda g: _condition_wait(),
    "unguarded write": lambda g: _writes(g, locked=False, threads=2),
    "locked write": lambda g: _writes(g, locked=True, threads=3),
    "exclusive write": lambda g: _writes(g, locked=False, threads=1),
}


def _kinds(module, scenario):
    guard = module.LockGuard()
    with module.lockguard_active(guard):
        SCENARIOS[scenario](guard)
    return [v.kind for v in guard.violations()]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_the_same_violation_kinds_under_each_guard(scenario):
    real = (threading.Lock, threading.RLock)
    port = _kinds(lg, scenario)
    assert (threading.Lock, threading.RLock) == real
    ref = _kinds(jlg, scenario)
    assert (threading.Lock, threading.RLock) == real
    assert port == ref
    want = {"inversion": ["lock-order"],
            "unguarded write": ["unguarded-write"]}.get(scenario, [])
    assert port == want


def test_the_two_guards_are_never_installed_together():
    ref = jlg.LockGuard()
    with jlg.lockguard_active(ref):
        with pytest.raises(RuntimeError, match="already patched"):
            lg.LockGuard().install()
    port = lg.LockGuard()
    with lg.lockguard_active(port):
        assert threading.Lock is not lg._REAL_LOCK
    assert threading.Lock is lg._REAL_LOCK
    assert threading.RLock.__module__ == "threading"


@pytest.mark.parametrize("value", [None, "", "1", "on", "true", "0", "off"])
def test_env_switch_matches_the_reference(value, monkeypatch):
    assert lg.ENV_LOCKGUARD == jlg.ENV_LOCKGUARD
    if value is None:
        monkeypatch.delenv(lg.ENV_LOCKGUARD, raising=False)
    else:
        monkeypatch.setenv(lg.ENV_LOCKGUARD, value)
    assert lg.enabled_from_env() == jlg.enabled_from_env()


def test_report_and_port_metrics():
    guard = lg.LockGuard()
    with lg.lockguard_active(guard):
        _inversion()
        assert "1 violation" in guard.report()
        guard.emit_metrics()
    gauges = tobs.METRICS.snapshot()["gauges"]
    assert gauges["lockguard.violations.lock_order"] == 1
    assert gauges["lockguard.violations.unguarded_write"] == 0
    guard.reset()
    assert guard.report() == "lockguard: clean (0 violations)"


def test_engine_traffic_clean_under_the_port_guard():
    """Locks the engine builds after install are instrumented, and its
    object under Eraser watch after ``start()`` (the reference's handoff
    rule) shows a consistent lockset while callers read stats."""
    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_len=32)
    model = ttr.TransformerLM(ttr.TransformerConfig(**kw), device="cpu")
    params = model.init()
    guard = lg.LockGuard()
    with lg.lockguard_active(guard):
        engine = InferenceEngine(model, params, cfg=ServingConfig(
            slots=2, paged=True, page_size=4, resolve_every=2),
            device="cpu").start()
        guard.watch(engine)
        try:
            pend = [engine.submit([1, 2, 3 + i], 4) for i in range(4)]
            for _ in range(5):
                engine.stats()
            assert all(len(p.result(120).tokens) == 4 for p in pend)
        finally:
            engine.stop()
            guard.unwatch(engine)
        assert isinstance(engine._lock, lg._GuardedLock)
    assert guard.violations() == [], guard.report()
