"""Resilience and observability of the port, after the JAX package's.

The acceptance chain is ``test_supervised_chaos_parity``: a corrupted
checkpoint write, a transient step failure and a data-pipeline failure in
ONE supervised run, which still ends bitwise equal to the port's own
fault-free run — resuming from the newest checkpoint that verifies, never
from the corrupted one.  The rest follows ``tests/test_resilience.py``
(injection, NaN rollback with the window skip, preemption, retries) and
the reference's goodput, flight-recorder and tracing tests; where both
packages can run the same plan, the port is held to the reference's
answer.
"""

import json
import signal
import threading
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import observability as jobs
from deeplearning4j_tpu.observability import tracing as jtracing
from deeplearning4j_tpu.observability.goodput import GoodputTracker as JGP
from deeplearning4j_tpu.observability.metrics import (
    MetricsRegistry as JRegistry)
from deeplearning4j_tpu.resilience import faults as jfaults
from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.observability import (FLIGHTREC, METRICS,
                                                    GoodputTracker,
                                                    MetricsRegistry,
                                                    StepTimer, trace)
from deeplearning4j_tpu_torch.observability.flightrec import FlightRecorder
from deeplearning4j_tpu_torch.observability.goodput import STATES
from deeplearning4j_tpu_torch.optimize import transforms as TT
from deeplearning4j_tpu_torch.parallel import (CheckpointManager,
                                               DataParallelTrainer)
from deeplearning4j_tpu_torch.resilience import (
    FAULTS, DataIteratorFault, DeviceLossError, DivergenceError,
    FaultInjector, FaultSpec, RetryPolicy, TrainingPreempted,
    TrainingSupervisor, TransientStepFault, corrupt_file, inject_faults,
    parse_fault_env)
from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"


# --------------------------------------------------------------- injector

def test_injector_probability_is_deterministic_and_matches_the_reference():
    def fire_indices(cls, seed):
        inj = cls()
        inj.arm([FaultSpec("train.step", probability=0.3, max_fires=0)],
                seed=seed)
        return [i for i in range(100) if inj.check("train.step") is not None]

    a = fire_indices(FaultInjector, 7)
    assert a and a == fire_indices(FaultInjector, 7)
    assert fire_indices(FaultInjector, 8) != a
    # the same plan and seed fire at the same calls in both packages
    assert a == fire_indices(jfaults.FaultInjector, 7)


def test_injector_at_step_and_max_fires():
    inj = FaultInjector()
    inj.arm([FaultSpec("train.step", at_step=3)], seed=0)
    fired = [s for s in range(1, 10) if inj.check("train.step", s) is not None]
    assert fired == [3]
    assert inj.fire_count("train.step") == 1 and inj.counts() == {
        "train.step": 1}


def test_maybe_fire_raises_mapped_exception():
    with inject_faults(FaultSpec("train.step", at_step=1)):
        with pytest.raises(TransientStepFault):
            FAULTS.maybe_fire("train.step", 1)
    assert FAULTS.check("train.step", 1) is None     # disarmed on exit
    with inject_faults(FaultSpec("data.next", at_step=2)):
        with pytest.raises(DataIteratorFault):
            FAULTS.maybe_fire("data.next", 2)
    assert METRICS.snapshot()["counters"]["faults.injected.data.next"] == 1


def test_parse_fault_env_matches_the_reference():
    raw = "train.step:at=5;checkpoint.write:kind=truncate,p=0.5,max=2;preempt"
    specs = parse_fault_env(raw)
    by_site = {s.site: s for s in specs}
    assert by_site["train.step"].at_step == 5
    assert by_site["checkpoint.write"].kind == "truncate"
    assert by_site["checkpoint.write"].probability == 0.5
    assert by_site["checkpoint.write"].max_fires == 2
    assert by_site["preempt"].probability == 1.0
    assert [vars(s) for s in specs] == [vars(s) for s in
                                        jfaults.parse_fault_env(raw)]
    with pytest.raises(ValueError):
        parse_fault_env("train.step:bogus=1")


def test_env_arming_is_lazy(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FAULTS", "train.step:at=2")
    monkeypatch.setenv("DL4J_TPU_FAULTS_SEED", "9")
    FAULTS.disarm()                          # re-allow env pickup
    assert FAULTS.check("train.step", 1) is None
    assert FAULTS.check("train.step", 2) is not None


def test_corrupt_file_kinds(tmp_path):
    p = tmp_path / "f"
    p.write_bytes(bytes(range(10)))
    corrupt_file(p, "bitflip")
    assert p.read_bytes()[5] == 5 ^ 0xFF and len(p.read_bytes()) == 10
    corrupt_file(p, "truncate")
    assert len(p.read_bytes()) == 5
    with pytest.raises(ValueError):
        corrupt_file(p, "melt")


# ------------------------------------------------------ supervised training

def _toy_problem():
    rng = np.random.default_rng(3)
    w_true = np.asarray([[1.0], [-2.0], [0.5]], np.float32)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    y = x @ w_true
    params = {"w": np.zeros((3, 1), np.float32)}
    return params, x, y


def loss_fn(p, xb, yb, gen=None):
    return ((xb @ p["w"] - yb) ** 2).mean()


class _Batch:
    def __init__(self, x, y):
        self.features, self.labels = x, y


def _batches(x, y, n=8, bs=8):
    return [_Batch(x[i * bs:(i + 1) * bs], y[i * bs:(i + 1) * bs])
            for i in range(n)]


def _new_trainer():
    return DataParallelTrainer(loss_fn, TT.chain(TT.momentum(0.9),
                                                 TT.sgd_lr(5e-2)), device=CPU)


def test_supervised_chaos_parity(tmp_path):
    """Transient step failure + corrupted checkpoint write + data-pipeline
    failure in one run: the supervisor completes, resumes from the newest
    VALID checkpoint, and ends bitwise equal to a fault-free run, with
    goodput's states summing to the wall-clock."""
    params, x, y = _toy_problem()
    data = _batches(x, y)
    t_ref = _new_trainer()
    s_ref, ref_losses = t_ref.fit(t_ref.init_state(params), data, epochs=1)

    mgr = CheckpointManager(tmp_path / "ckpt", keep=10)
    with inject_faults(FaultSpec("checkpoint.write", at_step=4,
                                 kind="bitflip"),
                       FaultSpec("train.step", at_step=5),
                       FaultSpec("data.next", at_step=7), seed=11):
        sup = TrainingSupervisor(
            mgr, RetryPolicy(max_attempts=4, backoff_base_s=0.01))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the walk-back's warning
            state, losses = sup.fit(_new_trainer(), params, data, epochs=1,
                                    checkpoint_every=2)

    assert state.step == s_ref.step == 8
    assert torch.equal(state.params["w"], s_ref.params["w"])
    assert all(torch.equal(a, b) for a, b in zip(state.tstate[0].values(),
                                                  s_ref.tstate[0].values()))
    assert state.key.tolist() == s_ref.key.tolist()
    # the losses of the last attempt's steps, keyed by step
    assert losses == ref_losses[-len(losses):]
    assert all(sup.report.losses_by_step[s] == ref_losses[s - 1]
               for s in sup.report.losses_by_step)
    assert sup.report.retries == 2 and len(sup.report.resumed_from) == 2
    assert 4 not in sup.report.resumed_from[:1]    # the corrupt save
    counters = METRICS.snapshot()["counters"]
    assert counters["checkpoint.corrupt_detected"] >= 1
    assert counters["resilience.retries"] == 2
    assert counters["faults.injected.train.step"] == 1
    assert counters["faults.injected.data.next"] == 1
    assert counters["faults.injected.checkpoint.write"] == 1
    prom = METRICS.to_prometheus()
    assert "resilience" in prom and "corrupt_detected" in prom
    rep = sup.report.goodput
    assert rep["accounted_seconds"] == pytest.approx(rep["wall_seconds"],
                                                     abs=1e-9)
    assert {"productive", "checkpoint", "restore",
            "rollback"} <= set(rep["states"])
    assert 0.0 < rep["fraction"] < 1.0
    # each retry left a flight-recorder bundle naming its fault
    bundles = sorted(FLIGHTREC.dump_dir.glob("flightrec-supervisor_retry-*"))
    assert len(bundles) == 2
    extra = json.loads(bundles[0].read_text())["extra"]
    assert "TransientStepFault" in extra["error"] or \
        "DataIteratorFault" in extra["error"]


def test_nan_guard_rolls_back_and_skips_window(tmp_path):
    params, x, y = _toy_problem()
    y = np.array(y)
    y[4 * 8:5 * 8] = np.nan                  # batch index 4 -> step 5
    data = _batches(x, y)
    mgr = CheckpointManager(tmp_path / "ckpt", keep=10)
    sup = TrainingSupervisor(mgr, RetryPolicy(max_attempts=3,
                                              backoff_base_s=0.01))
    state, losses = sup.fit(_new_trainer(), params, data, epochs=1,
                            checkpoint_every=1)
    assert sup.report.rollbacks == 1 and sup.report.skipped_steps == 1
    assert state.step == 7                   # 8 batches, one skipped
    assert all(np.isfinite(v) for v in losses)
    counters = METRICS.snapshot()["counters"]
    assert counters["resilience.nan_detected"] == 1
    assert counters["resilience.rollbacks"] == 1
    assert list(FLIGHTREC.dump_dir.glob("flightrec-divergence-*"))


def test_nan_guard_gives_up_after_max_rollbacks(tmp_path):
    params, x, y = _toy_problem()
    data = _batches(x, np.full_like(y, np.nan))
    sup = TrainingSupervisor(CheckpointManager(tmp_path / "ckpt", keep=10),
                             max_rollbacks=2)
    with pytest.raises(DivergenceError):
        sup.fit(_new_trainer(), params, data, epochs=1, checkpoint_every=1)
    assert sup.report.rollbacks == 3
    assert METRICS.snapshot()["counters"]["resilience.gave_up"] == 1


def test_injected_preemption_checkpoints_and_resumes(tmp_path):
    params, x, y = _toy_problem()
    data = _batches(x, y)
    t_ref = _new_trainer()
    s_ref, _ = t_ref.fit(t_ref.init_state(params), data, epochs=1)
    mgr = CheckpointManager(tmp_path / "ckpt", keep=10)
    with inject_faults(FaultSpec("preempt", at_step=3), seed=0):
        sup = TrainingSupervisor(mgr)
        state, _ = sup.fit(_new_trainer(), params, data, epochs=1,
                           checkpoint_every=4)
    assert sup.report.preemptions == 1
    assert 3 in sup.report.resumed_from      # emergency checkpoint at step 3
    assert state.step == s_ref.step
    assert torch.equal(state.params["w"], s_ref.params["w"])
    counters = METRICS.snapshot()["counters"]
    assert counters["resilience.emergency_checkpoints"] >= 1
    assert "drain" in sup.report.goodput["states"]


def test_real_signal_checkpoints_and_raises(tmp_path):
    """SIGTERM mid-run (delivered to the supervisor's handler, which it
    installs on the main thread): the trainer drains, writes the emergency
    checkpoint and the supervisor raises ``TrainingPreempted``; a new
    supervisor resumes from it to the fault-free end."""
    params, x, y = _toy_problem()
    data = _batches(x, y)
    t_ref = _new_trainer()
    s_ref, _ = t_ref.fit(t_ref.init_state(params), data, epochs=1)
    mgr = CheckpointManager(tmp_path / "ckpt", keep=10)
    sup = TrainingSupervisor(mgr)
    old = signal.getsignal(signal.SIGTERM)
    main = threading.current_thread() is threading.main_thread()

    def poll(step, _orig=sup._should_stop):
        if step == 2:
            if main:    # the handler is installed for the run
                assert signal.getsignal(signal.SIGTERM) == sup._handle_signal
            sup._handle_signal(signal.SIGTERM, None)
        return _orig(step)

    sup._should_stop = poll
    with pytest.raises(TrainingPreempted) as ei:
        sup.fit(_new_trainer(), params, data, epochs=1, checkpoint_every=0)
    assert ei.value.step == 2 and mgr.latest_valid_step() == 2
    assert signal.getsignal(signal.SIGTERM) is old       # handlers restored
    state, _ = TrainingSupervisor(mgr).fit(_new_trainer(), params, data,
                                           epochs=1)
    assert torch.equal(state.params["w"], s_ref.params["w"])
    assert METRICS.snapshot()["counters"]["resilience.signals"] == 1


def test_fit_trains_from_scratch_when_all_checkpoints_corrupt(tmp_path):
    params, x, y = _toy_problem()
    data = _batches(x, y)
    mgr = CheckpointManager(tmp_path / "ckpt", keep=10)
    t = _new_trainer()
    t.fit(t.init_state(params), data, epochs=1, checkpoint_manager=mgr)
    for s in mgr.all_steps():
        corrupt_file(tmp_path / "ckpt" / f"ckpt_{s:010d}" / "params.npz",
                     "truncate")
    t2 = _new_trainer()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state, _ = t2.fit(t2.init_state(params), data, epochs=1,
                          checkpoint_manager=mgr, resume=True)
    assert state.step == len(data)
    assert METRICS.snapshot()["counters"]["checkpoint.no_valid_restore"] == 1


def test_data_iterator_fault_is_retryable(tmp_path):
    params, x, y = _toy_problem()
    data = _batches(x, y)
    mgr = CheckpointManager(tmp_path / "ckpt", keep=10)
    with inject_faults(FaultSpec("data.next", at_step=5), seed=0):
        sup = TrainingSupervisor(mgr, RetryPolicy(max_attempts=3,
                                                  backoff_base_s=0.01))
        state, _ = sup.fit(_new_trainer(), params, data, epochs=1,
                           checkpoint_every=2)
    assert state.step == len(data) and sup.report.retries == 1


def test_device_loss_propagates_and_resize_waits_for_a_mesh(tmp_path):
    """One device has no survivors: a device loss propagates, with or
    without a trainer factory (as the reference's on a one-device mesh),
    and a resize is multi-device work."""
    params, x, y = _toy_problem()
    data = _batches(x, y)
    for i, trainer in enumerate((_new_trainer(),
                                 lambda devices: _new_trainer())):
        with inject_faults(FaultSpec("mesh.shrink", at_step=3)):
            sup = TrainingSupervisor(CheckpointManager(tmp_path / str(i)))
            with pytest.raises(DeviceLossError, match="at step 3"):
                sup.fit(trainer, params, data, epochs=1)
    assert METRICS.snapshot()["counters"]["resilience.device_losses"] == 2
    with pytest.raises(NotImplementedError, match="A10"):
        sup._resize(None, ["cuda:0", "cuda:1"], ["cuda:0"], 3, "shrink")


def test_supervise_generic_retry_and_give_up():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientStepFault("boom")
        return "ok"

    sup = TrainingSupervisor(policy=RetryPolicy(max_attempts=3,
                                                backoff_base_s=0.0))
    assert sup.supervise(flaky) == "ok" and calls["n"] == 3

    def doomed():
        raise TransientStepFault("always")

    sup2 = TrainingSupervisor(policy=RetryPolicy(max_attempts=2,
                                                 backoff_base_s=0.0))
    with pytest.raises(TransientStepFault):
        sup2.supervise(doomed)
    with pytest.raises(ValueError, match="checkpoint_manager"):
        TrainingSupervisor().fit(_new_trainer(), {}, [])


# ------------------------------------------------------------------ goodput

def _goodput_plan(gp):
    t = gp.started_at
    gp.transition("checkpoint", t + 1.0)
    gp.transition("productive", t + 1.5)
    gp.data_wait(t + 2.0, t + 2.3)           # >= threshold: carved as stall
    gp.data_wait(t + 2.4, t + 2.401)         # under it: stays productive
    gp.transition("rollback", t + 3.0)
    gp.transition("restore", t + 3.5)
    gp.transition("productive", t + 4.0)
    gp.transition("drain", t + 5.0)
    return gp.finish(t + 5.5)


def test_goodput_plan_matches_the_reference():
    port = _goodput_plan(GoodputTracker(registry=MetricsRegistry()))
    ref = _goodput_plan(JGP(registry=JRegistry()))
    assert port["states"] == ref["states"] == [
        "productive", "checkpoint", "productive", "stall", "productive",
        "rollback", "restore", "productive", "drain"]
    assert port["accounted_seconds"] == pytest.approx(port["wall_seconds"],
                                                      abs=1e-9)
    assert port["seconds"] == pytest.approx(ref["seconds"], abs=1e-9)
    assert port["fraction"] == pytest.approx(3.2 / 5.5)
    assert set(port["seconds"]) == set(STATES)


def test_goodput_phase_cap_gauges_and_errors():
    reg = MetricsRegistry()
    gp = GoodputTracker(registry=reg, timeline_cap=4)
    with gp.phase("checkpoint"):
        with gp.phase("stall"):
            assert gp.state == "stall"
        assert gp.state == "checkpoint"
    assert gp.state == "productive"
    t = gp._t0
    for i in range(20):
        gp.transition("stall" if i % 2 == 0 else "productive",
                      t + 0.1 * (i + 1))
    rep = gp.finish(t + 2.1)
    assert rep["timeline_dropped"] > 0 and len(rep["timeline"]) <= 4
    assert rep["accounted_seconds"] == pytest.approx(rep["wall_seconds"],
                                                     abs=1e-9)
    assert gp.finish() == rep                # idempotent
    gauges = reg.snapshot()["gauges"]
    assert all(f"goodput.seconds.{s}" in gauges for s in STATES)
    with pytest.raises(ValueError):
        GoodputTracker(registry=reg).transition("coffee_break")


# ----------------------------------------------------------- flight recorder

def test_flightrec_rings_capture_spans_metrics_and_faults(tmp_path):
    rec = FlightRecorder(dump_dir=tmp_path)
    rec.record_span({"name": "train_step", "ts": 1.0, "dur": 2.0,
                     "args": {"trace_id": "t1", "step": 7}})
    rec.record_metric("counter", "faults.injected.train.step", 1.0)
    assert rec.spans[-1]["step"] == 7 and rec.faults[-1]["site"] == \
        "train.step"
    bundle = json.loads(rec.dump("unit_test", extra={"k": "v"}).read_text())
    assert bundle["trigger"] == "unit_test" and bundle["extra"] == {"k": "v"}
    assert bundle["spans"][-1]["name"] == "train_step" and "metrics" in bundle
    rec.burst_n = 5
    dumps = [p for p in (rec.note_429() for _ in range(12)) if p is not None]
    assert len(dumps) == 1                   # burst fired once, cooldown


def test_flightrec_global_wiring_and_disabled_mode(tmp_path):
    FLIGHTREC.clear()
    with trace.span("wired_span"):
        pass
    METRICS.increment("faults.injected.some.site")
    assert any(s["name"] == "wired_span" for s in FLIGHTREC.spans)
    assert any(f["site"] == "some.site" for f in FLIGHTREC.faults)
    rec = FlightRecorder(dump_dir=tmp_path / "off")
    tobs.disable()
    try:
        rec.record_metric("counter", "faults.injected.x", 1.0)
        assert rec.dump("nope") is None
        METRICS.increment("off.counter")
        assert trace.span("x") is tobs.NOOP_SPAN
        assert METRICS.time("x") is tobs.NOOP_SPAN
    finally:
        tobs.enable()
    assert not rec.metric_events and not (tmp_path / "off").exists()
    assert "off.counter" not in METRICS.snapshot()["counters"]


# ------------------------------------------------------------------ tracing

def test_span_nesting_threads_and_export(tmp_path):
    trace.TRACER.clear()
    with trace.span("outer", a=1) as outer:
        with trace.span("inner") as inner:
            inner.set(b=2)
        got = {}

        def worker():
            with trace.span("threaded"):
                got["ctx"] = trace.current_trace_context()

        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=5)
        assert not th.is_alive()
    ev = {e["name"]: e for e in trace.TRACER.events}
    assert ev["inner"]["args"]["parent"] == "outer"
    assert ev["inner"]["args"]["trace_id"] == outer.trace_id
    assert ev["inner"]["args"]["b"] == 2 and ev["outer"]["args"]["a"] == 1
    assert ev["threaded"]["args"]["depth"] == 0    # a new thread, new trace
    path = trace.TRACER.save_chrome_trace(tmp_path / "t.json")
    loaded = json.loads(path.read_text())
    assert {e["name"] for e in loaded["traceEvents"]} == {
        "outer", "inner", "threaded"}
    sid = trace.record_span("explicit", 0.0, 0.5, trace_id="ab" * 16)
    assert trace.TRACER.events[-1]["args"]["span_id"] == sid
    jl = trace.TRACER.export_jsonl(tmp_path / "t.jsonl")
    assert len(jl.read_text().splitlines()) == 4


@pytest.mark.parametrize("header", [
    None, "", "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01", "00-xyz-" + "b" * 16 + "-01",
    "00-" + "A" * 32 + "-" + "B" * 16 + "-01", "1-2-3"])
def test_traceparent_parse_matches_the_reference(header):
    assert trace.parse_traceparent(header) == \
        jtracing.parse_traceparent(header)


def test_bind_and_traceparent_round_trip():
    with trace.bind("c" * 32, "d" * 16):
        with trace.span("child") as sp:
            assert sp.trace_id == "c" * 32 and sp.parent_id == "d" * 16
            tp = trace.current_traceparent()
    assert trace.parse_traceparent(tp) == ("c" * 32, sp.span_id)
    assert trace.current_traceparent() is None


# ------------------------------------------------------------------ metrics

def test_registry_renders_like_the_reference():
    """The same mutations render the same Prometheus text and snapshot in
    both packages' registries."""
    port, ref = MetricsRegistry(), JRegistry()
    for reg in (port, ref):
        reg.increment("a.count", 3)
        reg.gauge("b.level", 0.25)
        reg.observe_many("c.time", [0.001, 0.02, 0.3, 7.0])
    assert port.to_prometheus() == ref.to_prometheus()
    assert port.snapshot() == ref.snapshot()


def test_step_timer_and_listeners():
    reg = MetricsRegistry()
    seen = []
    reg.add_listener(lambda kind, name, value: seen.append((kind, name)))

    class Model:
        def score(self):
            return 1.5

    timer = StepTimer(reg, name="t")
    for i in range(3):
        timer.iteration_done(Model(), i)
    snap = reg.snapshot()
    assert snap["counters"]["t.iterations"] == 3
    assert snap["timers"]["t"]["count"] == 2
    assert snap["gauges"]["t.score"] == 1.5
    assert ("counter", "t.iterations") in seen and ("gauge", "t.score") in seen


def test_device_memory_and_state_bytes_on_cpu():
    reg = MetricsRegistry()
    assert tobs.sample_device_memory(reg) == 0
    assert reg.snapshot()["gauges"]["device.memory_stats_supported"] == 0.0
    n = tobs.sample_state_bytes({"w": torch.zeros(4)},
                                ({"w": torch.zeros(4, dtype=torch.float64)},),
                                reg)
    gauges = reg.snapshot()["gauges"]
    assert n == 1
    assert gauges["train.params_bytes.device.cpu0"] == 16.0
    assert gauges["train.opt_state_bytes.device.cpu0"] == 32.0
    # the reference degrades the same way without device stats
    assert jobs.sample_device_memory(JRegistry()) == 0
