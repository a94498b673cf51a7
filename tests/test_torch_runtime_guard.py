"""The port's transfer guard (``deeplearning4j_tpu_torch/analysis/
runtime.py``) on the CPU.

``guard_mode()`` reads ``DL4J_TPU_TRANSFER_GUARD`` as the reference's
does.  Reading a CPU tensor makes nothing wait, so on the CPU the guard
refuses nothing by default; its refusal logic is held here through the
``GUARDED_DEVICES`` seam, which makes the CPU the guarded device (the
``TorchDispatchMode`` mechanism, thread-local by nature).  With it: what
is refused and what ``allow_transfers()`` re-allows, ``log`` mode, the
opt-out, the scope (one thread guarded while another reads), and the
port's trainer ``fit`` and engine decode segments, which run under the
guard by default, passing with no refusal — and refusing a sync planted
in them, which shows the guard is installed there.  On the card the
same is checked by ``chip_smoke.py``'s phase 15j.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis import runtime as jrt
from deeplearning4j_tpu_torch.analysis import runtime as rt
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.optimize import transforms as TT
from deeplearning4j_tpu_torch.parallel.trainer import DataParallelTrainer
from deeplearning4j_tpu_torch.serving import InferenceEngine, ServingConfig
from torch_port_obs import port_obs  # noqa: F401  (autouse)
from torch_sync_guard import NoHostSync

CPU = "cpu"
KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=32)


@pytest.fixture
def seam(monkeypatch):
    """The CPU as the guarded device, the guard at its default level,
    and fresh counts."""
    monkeypatch.setattr(rt, "GUARDED_DEVICES", ("cpu",))
    monkeypatch.delenv(rt.ENV_FLAG, raising=False)
    rt.reset_counts()
    yield
    rt.reset_counts()


@pytest.mark.parametrize("value", [
    None, "", "0", "off", "OFF", " false ", "allow", "no", "disabled",
    "log", "disallow", "disallow_explicit", "log_explicit", "1", "on",
    "garbage"])
def test_guard_mode_matches_the_reference(value, monkeypatch):
    assert rt.ENV_FLAG == jrt.ENV_FLAG
    if value is None:
        monkeypatch.delenv(rt.ENV_FLAG, raising=False)
    else:
        monkeypatch.setenv(rt.ENV_FLAG, value)
    assert rt.guard_mode() == jrt.guard_mode()


SYNCS = {
    "item": lambda t: t.sum().item(),
    "float": lambda t: float(t.sum()),
    "bool": lambda t: bool(t.sum() > 0),
    "if": lambda t: 1 if t.sum() > 0 else 0,
    "0-d index": lambda t: t[t.argmax()],
    "nonzero": lambda t: t.nonzero(),
    "mask index": lambda t: t[t > 0],
    "masked_select": lambda t: torch.masked_select(t, t > 0),
}


@pytest.mark.parametrize("name", sorted(SYNCS))
def test_a_sync_is_refused_and_allow_transfers_re_allows_it(seam, name):
    t = torch.arange(-3.0, 5.0)
    with rt.hot_loop_guard() as mode:
        assert mode == "disallow"
        with pytest.raises(rt.HostSyncError, match="hot_loop_guard"):
            SYNCS[name](t)
        with rt.allow_transfers():
            SYNCS[name](t)
        # the innermost scope decides: a guard inside a fence refuses
        with rt.allow_transfers(), rt.hot_loop_guard():
            with pytest.raises(rt.HostSyncError):
                SYNCS[name](t)
    SYNCS[name](t)       # outside every scope
    assert rt.counts()["refused"] == 2


def test_device_work_passes_under_the_guard(seam):
    t = torch.arange(8.0)
    with rt.hot_loop_guard(), NoHostSync() as seen:
        out = torch.where(t > 3, t * 2, t).cumsum(0)
        idx = torch.tensor([1, 5])
        out[idx] = 0.0
    assert seen.seen > 0 and out.shape == (8,)
    assert rt.counts() == {"guarded": 1, "refused": 0, "logged": 0}


def test_reading_a_cpu_tensor_is_free_without_the_seam(monkeypatch):
    monkeypatch.delenv(rt.ENV_FLAG, raising=False)
    rt.reset_counts()
    with rt.hot_loop_guard() as mode:
        assert mode == "disallow"
        assert torch.ones(3).sum().item() == 3.0
    assert rt.counts()["refused"] == 0


@pytest.mark.parametrize("value", ["0", "off", "allow"])
def test_opting_out_installs_nothing(seam, monkeypatch, value):
    monkeypatch.setenv(rt.ENV_FLAG, value)
    with rt.hot_loop_guard() as mode:
        assert mode is None
        assert torch.ones(3).sum().item() == 3.0
    assert rt.counts()["guarded"] == 0


@pytest.mark.parametrize("value", ["log", "log_explicit"])
def test_log_mode_counts_without_raising(seam, monkeypatch, caplog, value):
    monkeypatch.setenv(rt.ENV_FLAG, value)
    with rt.hot_loop_guard() as mode:
        assert mode == value
        for _ in range(3):
            torch.ones(2).sum().item()
    assert rt.counts()["logged"] == 3 and rt.counts()["refused"] == 0
    assert "log mode" in caplog.text


def test_explicit_levels_act_as_their_plain_forms(seam, monkeypatch):
    monkeypatch.setenv(rt.ENV_FLAG, "disallow_explicit")
    with rt.hot_loop_guard():
        with pytest.raises(rt.HostSyncError):
            torch.ones(2).sum().item()


def test_the_guard_is_scoped_to_its_thread(seam):
    """While one thread is inside the guard, another thread reads the
    same values unguarded and passes; the guarded thread's read is
    refused — neither sees the other's scope."""
    t = torch.arange(6.0)
    inside, read, results = threading.Event(), threading.Event(), {}

    def guarded():
        with rt.hot_loop_guard():
            inside.set()
            read.wait(10)
            try:
                t.sum().item()
                results["guarded"] = "passed"
            except rt.HostSyncError:
                results["guarded"] = "refused"

    def plain():
        inside.wait(10)
        results["plain"] = (t.sum().item(), float(t.max()),
                            int(t.nonzero().shape[0]))
        read.set()

    threads = [threading.Thread(target=f) for f in (guarded, plain)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert results == {"guarded": "refused", "plain": (15.0, 5.0, 5)}
    assert rt.counts()["refused"] == 1


# ------------------------------------------- the card's sync check, stubbed
SYNC_MESSAGE = ("called a synchronizing CUDA operation (stand-in for "
                "PyTorch's sync-check warning)")


class StubSyncCheck:
    """``torch.cuda``'s sync-check setting (0 default, 1 warn, 2 error)
    and the warnings that reach ``warnings.showwarning``."""

    def __init__(self, mode):
        self.mode, self.sets, self.shown = mode, [], []

    def get(self):
        return self.mode

    def set(self, mode):
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
        self.sets.append(self.mode)

    def show(self, message, *args, **kw):
        self.shown.append(str(message))


@pytest.fixture
def sync_check(monkeypatch):
    """The guard's GPU mechanism on the CPU: ``torch.cuda`` reported
    available, its sync-check get/set stubbed, a sync stood in for by
    the warning PyTorch issues on the syncing thread."""
    def make(mode):
        check = StubSyncCheck(mode)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", check.get)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", check.set)
        monkeypatch.setattr(warnings, "showwarning", check.show)
        return check

    monkeypatch.setattr(rt, "_cuda_ok", True)
    monkeypatch.setattr(rt, "_debug_users", 0)
    monkeypatch.setattr(rt, "_debug_set", False)
    monkeypatch.delenv(rt.ENV_FLAG, raising=False)
    rt.reset_counts()
    yield make
    rt.reset_counts()


def _sync():
    warnings.warn(SYNC_MESSAGE, UserWarning)


def _sync_on_another_thread():
    th = threading.Thread(target=_sync)
    th.start()
    th.join(10)


@pytest.mark.parametrize("caller", [0, 1, 2],
                         ids=["default", "warn", "error"])
def test_the_sync_check_keeps_the_callers_setting(sync_check, caller):
    """The guard turns the check on only from "default" and drops the
    warnings that switch causes on an unguarded thread; a caller's
    "warn" keeps showing them, a caller's "error" is left in place;
    the check ends as the caller left it."""
    check = sync_check(caller)
    with rt.hot_loop_guard():
        assert check.mode == (1 if caller == 0 else caller)
        with pytest.raises(rt.HostSyncError):
            _sync()
        with rt.allow_transfers():
            _sync()
        _sync_on_another_thread()
    assert check.mode == caller
    assert check.sets == ([1, 0] if caller == 0 else [])
    assert check.shown == ([] if caller == 0 else [SYNC_MESSAGE] * 2)
    assert rt.counts()["refused"] == 1


def test_the_sync_check_follows_a_caller_who_changes_it_meanwhile(
        sync_check):
    """A caller's change while a guard is open is not undone at its exit:
    set to "error" it stays; turned off, a guard entered after turns it
    back on, and the last exit turns it off."""
    check = sync_check(0)
    with rt.hot_loop_guard():
        check.set("error")
    assert check.mode == 2
    check = sync_check(2)
    with rt.hot_loop_guard():
        check.set(0)                 # as a caller's own ``finally`` does
    assert check.mode == 0 and check.sets == [0]
    done, inside = threading.Event(), threading.Event()

    def other():
        with rt.hot_loop_guard():
            inside.set()
            done.wait(10)

    th = threading.Thread(target=other)
    with rt.hot_loop_guard():
        th.start()
        inside.wait(10)
        check.set(0)
        with rt.hot_loop_guard():     # nested: the check back on
            assert check.mode == 1
            with pytest.raises(rt.HostSyncError):
                _sync()
        done.set()
        th.join(10)
        assert check.mode == 1
    assert check.mode == 0 and check.sets == [0, 1, 0, 1, 0]


def test_the_sync_check_logs_in_log_mode(sync_check, monkeypatch, caplog):
    check = sync_check(0)
    monkeypatch.setenv(rt.ENV_FLAG, "log")
    with rt.hot_loop_guard():
        _sync()
        _sync()
    assert rt.counts()["logged"] == 2 and check.shown == []
    assert "log mode" in caplog.text


# ------------------------------------------------------- trainer and engine
def _toy_data(n_batches=5):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6, 1))
    data = []
    for n in [16, 9, 16, 5, 16][:n_batches]:
        x = rng.normal(size=(n, 6)).astype(np.float32)
        data.append(DataSet(x, (x @ w).astype(np.float32)))
    return {"w": np.zeros((6, 1), np.float32)}, data


def _loss(p, x, y, gen=None):
    return ((x @ p["w"] - y) ** 2).mean()


def test_fit_runs_under_the_guard_with_no_refusal(seam):
    params, data = _toy_data()
    trainer = DataParallelTrainer(_loss, TT.sgd_lr(0.05), device=CPU)
    state, losses = trainer.fit(trainer.init_state(params), data,
                                resolve_every=2)
    assert state.step == len(data) and all(np.isfinite(losses))
    assert rt.counts()["guarded"] == 1 and rt.counts()["refused"] == 0
    # the same run with the guard off gives the same losses
    rt.GUARDED_DEVICES = ("cuda",)
    t2 = DataParallelTrainer(_loss, TT.sgd_lr(0.05), device=CPU)
    assert t2.fit(t2.init_state(params), data, resolve_every=2)[1] == losses


def test_a_sync_planted_in_the_fit_loop_is_refused(seam):
    params, data = _toy_data(2)

    def reading_loss(p, x, y, gen=None):
        loss = _loss(p, x, y)
        float(loss.detach())   # the slip the guard exists for
        return loss

    trainer = DataParallelTrainer(reading_loss, TT.sgd_lr(0.05), device=CPU)
    with pytest.raises(rt.HostSyncError):
        trainer.fit(trainer.init_state(params), data)


@pytest.fixture(scope="module")
def lm():
    model = ttr.TransformerLM(ttr.TransformerConfig(**KW), device=CPU)
    return model, model.init()


def _engine(lm, **cfg):
    model, params = lm
    return InferenceEngine(model, params, cfg=ServingConfig(
        slots=2, resolve_every=3, **cfg), device=CPU)


@pytest.mark.parametrize("cfg", [{}, {"paged": True, "page_size": 4}],
                         ids=["dense", "paged"])
def test_decode_segments_run_under_the_guard(seam, lm, cfg):
    """Sampled tokens (the noise ring drawn ahead on the device) equal the
    offline sampler's with every decode segment under the guard (the CPU
    guarded), and no refusal."""
    model, params = lm
    with _engine(lm, **cfg) as engine:
        toks = engine.generate([1, 2, 3], 7, temperature=0.7, seed=1,
                               timeout=120).tokens
    assert toks == model.sample(params, [1, 2, 3], 7, temperature=0.7,
                                seed=1)[3:]
    c = rt.counts()
    assert c["guarded"] >= 3 and c["refused"] == 0


def test_decode_segment_passes_no_host_sync(lm, monkeypatch):
    """The engine's decode segment, entered as the serve loop enters it
    (under ``hot_loop_guard()``), reads nothing back: ``NoHostSync``
    and the patched host reads see nothing."""
    engine = _engine(lm)
    real = engine._decode_segment
    calls = []

    def checked():
        def boom(*a, **k):
            raise AssertionError("host sync inside the decode segment")
        with monkeypatch.context() as m:
            for name in ("item", "cpu", "tolist", "numpy", "nonzero"):
                m.setattr(torch.Tensor, name, boom)
            with NoHostSync():
                out = real()
        calls.append(len(out))
        return out

    engine._decode_segment = checked
    with engine:
        engine.generate([4, 5, 6], 5, timeout=120)
    assert calls


def test_a_sync_planted_in_the_decode_segment_is_refused(seam, lm):
    engine = _engine(lm)
    real = engine._plan_step

    def reading_plan(width, j):
        engine._state["pos"].sum().item()
        return real(width, j)

    engine._plan_step = reading_plan
    with engine:
        with pytest.raises(rt.HostSyncError):
            engine.generate([1, 2], 4, timeout=120)
    assert rt.counts()["refused"] >= 1


def test_two_engines_serve_concurrently_under_the_guard(seam, lm):
    """Two engines in one interpreter, four requests each from their own
    threads: both finish, tokens equal each engine's unguarded run, no
    refusal — one serve thread's fence is never refused for the other's
    guard."""
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11]]
    want = []
    rt.GUARDED_DEVICES = ("cuda",)
    for cfg in ({}, {"paged": True, "page_size": 4}):
        with _engine(lm, **cfg) as e:
            want.append([e.generate(p, 5, timeout=120).tokens
                         for p in prompts])
    rt.GUARDED_DEVICES = ("cpu",)
    rt.reset_counts()
    got = [None, None]

    def serve(i, cfg):
        with _engine(lm, **cfg) as e:
            pend = [e.submit(p, 5) for p in prompts]
            got[i] = [p.result(120).tokens for p in pend]

    threads = [threading.Thread(target=serve, args=(i, cfg)) for i, cfg in
               enumerate(({}, {"paged": True, "page_size": 4}))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert got == want
    assert rt.counts()["refused"] == 0 and rt.counts()["guarded"] >= 2
