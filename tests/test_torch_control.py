"""The port's control plane against the reference's: the autoscaler's
decisions over a scripted signal feed, the brownout ladder's hysteresis,
per-tenant fair share, priority tiers with aging and expiry sweeps, and
the router's warm-gated admission and drain (the battery of
``tests/test_control.py``, run through both packages).

Every decision test drives a controller with an injected clock and
hand-written ``ControlSignals`` — no threads, no sleeps, no engine.  Each
battery test runs once per package (``P``) with the same expectations;
the ``*_equal_the_reference`` tests replay seeded random sequences
through both and hold the decisions equal, step by step.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import deeplearning4j_tpu.control as jctl
import deeplearning4j_tpu.control.autoscaler as jauto
import deeplearning4j_tpu.control.overload as jover
import deeplearning4j_tpu.observability as jobs
import deeplearning4j_tpu.resilience.faults as jfaults
import deeplearning4j_tpu.serving.batcher as jbatch
import deeplearning4j_tpu.serving.router.replicas as jrep
import deeplearning4j_tpu.serving.router.router as jrouter
import deeplearning4j_tpu_torch.control as tctl
import deeplearning4j_tpu_torch.control.autoscaler as tauto
import deeplearning4j_tpu_torch.control.overload as tover
import deeplearning4j_tpu_torch.observability as tobs
import deeplearning4j_tpu_torch.resilience.faults as tfaults
import deeplearning4j_tpu_torch.serving.batcher as tbatch
import deeplearning4j_tpu_torch.serving.router.replicas as trep
import deeplearning4j_tpu_torch.serving.router.router as trouter
from torch_port_obs import port_obs  # noqa: F401  (autouse)


def _pkg(ctl, auto, over, obs, faults, batch, rep, router):
    return SimpleNamespace(
        Autoscaler=ctl.Autoscaler, AutoscalerConfig=ctl.AutoscalerConfig,
        ControlSignals=ctl.ControlSignals, BrownoutConfig=ctl.BrownoutConfig,
        BrownoutController=ctl.BrownoutController,
        OverloadGate=ctl.OverloadGate, Throttled=ctl.Throttled,
        TokenBucketAdmission=ctl.TokenBucketAdmission,
        BucketConfig=over.BucketConfig, router_actuators=auto.router_actuators,
        router_signals=auto.router_signals, obs=obs, METRICS=obs.METRICS,
        FaultSpec=faults.FaultSpec, inject_faults=faults.inject_faults,
        RequestQueue=batch.RequestQueue, GenerateRequest=batch.GenerateRequest,
        DeadlineExceeded=batch.DeadlineExceeded, Replica=rep.Replica,
        PrefixRouter=router.PrefixRouter, RouterConfig=router.RouterConfig)


PKGS = {
    "port": _pkg(tctl, tauto, tover, tobs, tfaults, tbatch, trep, trouter),
    "ref": _pkg(jctl, jauto, jover, jobs, jfaults, jbatch, jrep, jrouter),
}


@pytest.fixture(params=["port", "ref"])
def P(request):
    return PKGS[request.param]


# ------------------------------------------------------------------ harness
class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


class _Harness:
    """Scripted-feed autoscaler: one ControlSignals a ``step()``; the
    actuators move a fake pool size and log their calls."""

    def __init__(self, P, size=1, **cfg_kw):
        cfg_kw.setdefault("interval_s", 0.01)
        cfg_kw.setdefault("cooldown_s", 5.0)
        cfg_kw.setdefault("down_consecutive", 3)
        self.P = P
        self.cfg = P.AutoscalerConfig(**cfg_kw)
        self.clock = _Clock()
        self.size = size
        self.feed = []
        self.actions = []
        self.fail_next = None
        self.scaler = P.Autoscaler(
            self._read, self._up, self._down, lambda: self.size,
            cfg=self.cfg, clock=self.clock)

    def _read(self):
        return self.feed.pop(0) if self.feed else self.P.ControlSignals()

    def _up(self):
        if self.fail_next == "up":
            self.fail_next = None
            raise RuntimeError("actuator broke")
        self.size += 1
        self.actions.append("up")

    def _down(self):
        if self.fail_next == "down":
            self.fail_next = None
            raise RuntimeError("actuator broke")
        self.size -= 1
        self.actions.append("down")

    def play(self, sig, dt=1.0):
        self.clock.tick(dt)
        self.feed.append(sig)
        return self.scaler.step()


def burning(P):
    return P.ControlSignals(burn=2.0)


def quiet(P):
    return P.ControlSignals(burn=0.1, queue_depth=0)


# ------------------------------------------------------------- decisions
def test_scale_up_on_burn(P):
    h = _Harness(P)
    assert h.play(burning(P)) == "up"
    assert h.size == 2
    assert P.METRICS.snapshot()["counters"]["control.scale_up"] == 1


def test_scale_up_on_queue_depth_and_forecast(P):
    h = _Harness(P, queue_high=10)
    assert h.play(P.ControlSignals(burn=0.0, queue_depth=50)) == "up"
    h2 = _Harness(P, ttb_horizon_s=60.0)
    assert h2.play(P.ControlSignals(burn=0.0, ttb_s=30.0)) == "up"
    h3 = _Harness(P, ttb_horizon_s=60.0)
    assert h3.play(P.ControlSignals(burn=0.0, ttb_s=10_000.0)) is None


def test_cooldown_one_action_per_window(P):
    h = _Harness(P)
    assert h.play(burning(P)) == "up"
    assert h.play(burning(P), dt=1.0) is None
    assert h.play(burning(P), dt=1.0) is None
    assert h.play(burning(P), dt=10.0) == "up"
    assert h.actions == ["up", "up"]


def test_scale_down_needs_consecutive_quiet_windows(P):
    h = _Harness(P, size=3)
    assert h.play(quiet(P), dt=10.0) is None
    assert h.play(quiet(P)) is None
    assert h.play(quiet(P)) == "down"
    assert h.size == 2
    assert P.METRICS.snapshot()["counters"]["control.scale_down"] == 1


def test_hysteresis_blocks_flapping(P):
    h = _Harness(P, size=2)
    for _ in range(6):
        assert h.play(quiet(P), dt=10.0) is None
        h.play(burning(P), dt=10.0)
    assert "down" not in h.actions


def test_bounds_clamp(P):
    h = _Harness(P, size=4, max_replicas=4, min_replicas=1)
    assert h.play(burning(P)) is None
    h2 = _Harness(P, size=1, min_replicas=1)
    for _ in range(5):
        assert h2.play(quiet(P), dt=10.0) is None
    assert h2.actions == []


def test_failed_actuator_burns_the_cooldown_window(P):
    h = _Harness(P)
    h.fail_next = "up"
    assert h.play(burning(P)) == "up"
    assert h.size == 1
    assert P.METRICS.snapshot()["counters"]["control.scale_errors"] == 1
    assert h.play(burning(P), dt=1.0) is None
    assert h.play(burning(P), dt=10.0) == "up"
    assert h.size == 2


def test_killed_autoscaler_degrades_to_static_capacity(P):
    h = _Harness(P)
    assert h.play(burning(P)) == "up"
    with P.inject_faults(P.FaultSpec("control.autoscaler", probability=1.0)):
        assert h.play(burning(P), dt=10.0) is None
    assert h.scaler.dead
    snap = P.METRICS.snapshot()
    assert snap["counters"]["control.autoscaler_killed"] == 1
    assert snap["gauges"]["control.autoscaler_alive"] == 0.0
    for _ in range(3):
        assert h.play(burning(P), dt=10.0) is None
    assert h.size == 2 and h.actions == ["up"]
    assert h.scaler.start() is False


def test_daemon_lifecycle(P):
    h = _Harness(P)
    assert h.scaler.start() is True
    assert h.scaler.start() is False
    assert h.scaler.running
    h.scaler.stop()
    assert not h.scaler.running


def _random_feed(rng, n):
    """Runs of quiet windows between random ones (a burn that may be
    missing, a queue depth, a forecast), on random clock ticks."""
    feed = []
    for _ in range(n):
        if rng.random() < 0.55:
            burn = None if rng.random() < 0.2 else float(rng.choice(
                [0.0, 0.1, 0.25]))
            depth = int(rng.integers(0, 3))
            ttb = None if rng.random() < 0.5 else float(rng.choice(
                [121.0, float("inf")]))
        else:
            burn = None if rng.random() < 0.1 else float(rng.choice(
                [0.3, 0.9, 1.0, 1.5, 3.0]))
            depth = int(rng.choice([0, 3, 10, 40]))
            ttb = None if rng.random() < 0.5 else float(rng.choice(
                [5.0, 60.0, 120.0, 121.0]))
        dt = float(rng.choice([0.5, 1.0, 3.0, 11.0]))
        feed.append((burn, depth, ttb, dt))
    return feed


@pytest.mark.parametrize("seed", range(4))
def test_autoscaler_decisions_equal_the_reference(seed):
    """The same random signal and clock sequence through both packages'
    autoscalers (a failing actuator now and then) gives the same decision
    at every window, and the same pool sizes."""
    feed = _random_feed(np.random.default_rng(seed), 80)
    fails = set(np.random.default_rng(seed + 100).choice(80, 6).tolist())
    runs = {}
    for name, P in PKGS.items():
        h = _Harness(P, size=2, max_replicas=5, queue_high=32,
                     cooldown_s=4.0, down_consecutive=2)
        trail = []
        for i, (burn, depth, ttb, dt) in enumerate(feed):
            if i in fails:
                h.fail_next = "up" if i % 2 else "down"
            trail.append((h.play(P.ControlSignals(burn=burn,
                                                  queue_depth=depth,
                                                  ttb_s=ttb), dt=dt),
                          h.size))
        runs[name] = trail
    assert runs["port"] == runs["ref"]
    assert any(d == "up" for d, _ in runs["port"])
    assert any(d == "down" for d, _ in runs["port"])


# -------------------------------------------------------------- brownout
class _FakeEngine:
    def __init__(self):
        self.spec = True
        self.cap = None

    def set_speculative(self, enabled):
        self.spec = bool(enabled)
        return self.spec

    def set_max_new_cap(self, cap):
        self.cap = cap


def test_brownout_ladder_and_hysteresis(P):
    clock = _Clock()
    eng = _FakeEngine()
    bc = P.BrownoutController(eng, P.BrownoutConfig(
        enter_burn=(1.0, 2.0, 4.0), exit_fraction=0.5, dwell_s=1.0,
        clamp_max_new=8), clock=clock)
    clock.tick(10)
    assert bc.update(0.5) == 0 and eng.spec and eng.cap is None
    assert bc.update(1.2) == 1
    assert not eng.spec and eng.cap is None
    clock.tick(2)
    assert bc.update(2.5) == 2 and eng.cap == 8
    clock.tick(2)
    assert bc.update(9.0) == 3
    assert bc.shed_background
    clock.tick(2)
    assert bc.update(3.0) == 3
    clock.tick(2)
    assert bc.update(1.5) == 2
    clock.tick(2)
    assert bc.update(0.4) == 1
    clock.tick(2)
    assert bc.update(0.4) == 0
    assert eng.spec and eng.cap is None
    snap = P.METRICS.snapshot()
    assert snap["gauges"]["control.brownout_level"] == 0.0
    assert snap["counters"]["control.brownout_transitions"] == 6


def test_brownout_dwell_and_missing_signal_hold_level(P):
    clock = _Clock()
    bc = P.BrownoutController(None, P.BrownoutConfig(dwell_s=5.0),
                              clock=clock)
    clock.tick(10)
    assert bc.update(2.5) == 2
    clock.tick(1)
    assert bc.update(0.0) == 2
    assert bc.update(None) == 2
    clock.tick(10)
    assert bc.update(0.0) == 1


@pytest.mark.parametrize("seed", range(4))
def test_brownout_ladder_equals_the_reference(seed):
    """A random burn sequence (gaps included) on random clock ticks: the
    same level and the same engine settings after every update."""
    rng = np.random.default_rng(seed)
    burns = [None if rng.random() < 0.1 else float(rng.uniform(0, 6))
             for _ in range(120)]
    ticks = rng.choice([0.2, 0.5, 1.0, 2.5], size=120).tolist()
    trails = {}
    for name, P in PKGS.items():
        clock = _Clock()
        eng = _FakeEngine()
        bc = P.BrownoutController(eng, P.BrownoutConfig(dwell_s=1.0),
                                  clock=clock)
        trail = []
        for b, dt in zip(burns, ticks):
            clock.tick(dt)
            trail.append((bc.update(b), eng.spec, eng.cap,
                          bc.shed_background))
        trails[name] = trail
    assert trails["port"] == trails["ref"]
    assert {lv for lv, *_ in trails["port"]} >= {0, 1, 2, 3}


# ------------------------------------------------------------- fair share
def _req(P, tenant="", max_new=10, priority=0):
    return P.GenerateRequest(prompt=[1], max_new_tokens=max_new,
                             tenant=tenant, priority=priority)


def test_token_bucket_fair_share_isolates_tenants(P):
    clock = _Clock()
    bucket = P.TokenBucketAdmission(
        P.BucketConfig(rate_tokens_s=10.0, burst_tokens=20.0), clock=clock)
    bucket.charge(_req(P, tenant="a", max_new=15))
    with pytest.raises(P.Throttled) as ei:
        bucket.charge(_req(P, tenant="a", max_new=15))
    assert ei.value.status == 429
    bucket.charge(_req(P, tenant="b", max_new=15))
    clock.tick(2.0)
    bucket.charge(_req(P, tenant="a", max_new=15))
    snap = P.METRICS.snapshot()["counters"]
    assert snap["control.throttled"] == 1
    assert snap["tenant.a.throttled"] == 1
    assert "tenant.b.throttled" not in snap


@pytest.mark.parametrize("seed", range(3))
def test_token_bucket_admissions_equal_the_reference(seed):
    """Three tenants' random requests on a random clock: the same
    admit/throttle verdict per request and the same balances."""
    rng = np.random.default_rng(seed)
    plan = [(str(rng.choice(["a", "b", "c"])), int(rng.integers(1, 40)),
             float(rng.choice([0.0, 0.1, 0.5, 2.0]))) for _ in range(150)]
    trails = {}
    for name, P in PKGS.items():
        clock = _Clock()
        bucket = P.TokenBucketAdmission(
            P.BucketConfig(rate_tokens_s=25.0, burst_tokens=60.0),
            clock=clock)
        trail = []
        for tenant, cost, dt in plan:
            clock.tick(dt)
            try:
                bucket.charge(_req(P, tenant=tenant, max_new=cost))
                ok = True
            except P.Throttled:
                ok = False
            trail.append((ok, bucket.available(tenant)))
        trails[name] = trail
    assert trails["port"] == trails["ref"]
    assert {ok for ok, _ in trails["port"]} == {True, False}


def test_overload_gate_sheds_background_only_at_level_3(P):
    clock = _Clock()
    bc = P.BrownoutController(None, P.BrownoutConfig(dwell_s=0.0),
                              clock=clock)
    gate = P.OverloadGate(brownout=bc)
    clock.tick(10)
    bc.update(9.0)
    assert bc.level == 3
    with pytest.raises(P.Throttled):
        gate(_req(P, tenant="bg", priority=1))
    gate(_req(P, tenant="fg", priority=0))
    clock.tick(10)
    bc.update(0.0)
    gate(_req(P, tenant="bg", priority=1))
    assert P.METRICS.snapshot()["counters"]["control.shed"] == 1


def test_gate_installs_on_the_port_engine():
    """``OverloadGate.install`` goes through the engine's admission hook:
    an over-quota tenant's submit raises ``Throttled`` (HTTP 429) and is
    counted under its bounded label."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.serving import InferenceEngine, ServingConfig

    cfg = ttr.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                                n_layers=1, d_ff=32, max_len=16,
                                dtype=torch.float32)
    model = ttr.TransformerLM(cfg, device="cpu")
    engine = InferenceEngine(model, model.init(), cfg=ServingConfig(),
                             device="cpu")
    clock = _Clock()
    gate = tctl.OverloadGate(bucket=tctl.TokenBucketAdmission(
        tover.BucketConfig(rate_tokens_s=1.0, burst_tokens=8.0),
        clock=clock)).install(engine)
    assert gate.bucket is not None
    engine.submit([1, 2], 6, tenant="noisy")
    with pytest.raises(tctl.Throttled) as ei:
        engine.submit([1, 2], 6, tenant="noisy")
    assert ei.value.status == 429
    engine.submit([1, 2], 6, tenant="calm")
    counters = tobs.METRICS.snapshot()["counters"]
    assert counters["tenant.noisy.throttled"] == 1
    assert "tenant.calm.throttled" not in counters
    engine.stop()


# ------------------------------------------------- priority tiers + aging
def test_interactive_claimed_ahead_of_background(P):
    q = P.RequestQueue(max_depth=8, max_batch_delay_ms=0.0)
    bg = q.submit(_req(P, priority=1))
    fg = q.submit(_req(P, priority=0))
    assert q.take(8) == [fg, bg]


def test_claim_preempts_unaged_background(P):
    q = P.RequestQueue(max_depth=8, max_batch_delay_ms=0.0, aging_s=60.0)
    bg = q.submit(_req(P, priority=1))
    [p] = q.take(1)
    assert p is bg
    fg = q.submit(_req(P, priority=0))
    assert q.claim(bg) is False
    assert not bg.done()
    assert P.METRICS.snapshot()["counters"]["serving.preempted"] == 1
    assert q.take(8) == [fg, bg]
    assert q.claim(fg) and q.claim(bg)


def test_aged_background_cannot_starve(P):
    q = P.RequestQueue(max_depth=8, max_batch_delay_ms=0.0, aging_s=0.05)
    bg = q.submit(_req(P, priority=1))
    time.sleep(0.06)
    fg = q.submit(_req(P, priority=0))
    assert q.take(8) == [bg, fg]
    q2 = P.RequestQueue(max_depth=8, max_batch_delay_ms=0.0, aging_s=0.05)
    bg2 = q2.submit(_req(P, priority=1))
    [_] = q2.take(1)
    time.sleep(0.06)
    q2.submit(_req(P, priority=0))
    assert q2.claim(bg2) is True


# ----------------------------------------------------- expiry sweeps
def test_expiry_decrements_depth_gauge_without_a_take(P):
    q = P.RequestQueue(max_depth=8, max_batch_delay_ms=0.0)
    past = time.monotonic() - 1.0
    pends = [q.submit(_req(P, tenant="t")) for _ in range(3)]
    for p in pends:
        p.request.deadline_s = past
    assert P.METRICS.snapshot()["gauges"]["serving.queue.depth"] == 3
    assert q.depth() == 0
    snap = P.METRICS.snapshot()
    assert snap["gauges"]["serving.queue.depth"] == 0
    assert snap["counters"]["serving.deadline_dropped"] == 3
    assert snap["counters"]["tenant.t.deadline_dropped"] == 3
    for p in pends:
        with pytest.raises(P.DeadlineExceeded):
            p.result(0)


def test_expiry_sweep_frees_room_for_live_submits(P):
    q = P.RequestQueue(max_depth=2, max_batch_delay_ms=0.0)
    a = q.submit(_req(P))
    b = q.submit(_req(P))
    a.request.deadline_s = b.request.deadline_s = time.monotonic() - 1.0
    live = q.submit(_req(P))
    assert q.take(8) == [live]


def test_queue_expiry_contention(P):
    """Submitters, takers and depth pollers on one queue while deadlines
    expire: every request resolves exactly once and the depth gauge lands
    on the true (empty) depth."""
    q = P.RequestQueue(max_depth=256, max_batch_delay_ms=0.0, aging_s=0.01)
    done = threading.Event()
    taken, lock = [], threading.Lock()

    def submitter(seed):
        for i in range(40):
            try:
                p = q.submit(P.GenerateRequest(
                    prompt=[1], max_new_tokens=1,
                    priority=(seed + i) % 2,
                    deadline_s=time.monotonic()
                    + (0.0005 if i % 3 == 0 else 5.0)))
            except Exception:
                continue
            with lock:
                taken.append(p)

    def taker():
        while not done.is_set():
            for p in q.take(4, block_s=0.001):
                if q.claim(p):
                    p._complete("served")

    def poller():
        while not done.is_set():
            q.depth()

    threads = [threading.Thread(target=submitter, args=(s,))
               for s in range(4)]
    threads += [threading.Thread(target=taker) for _ in range(2)]
    threads.append(threading.Thread(target=poller))
    for t in threads:
        t.start()
    for t in threads[:4]:
        t.join(timeout=30.0)
    deadline = time.monotonic() + 5.0
    while q.depth() > 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    done.set()
    for t in threads[4:]:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    for p in q.drain():
        p._fail(P.DeadlineExceeded("leftover"))
    assert len(taken) == 160
    assert all(p.done() for p in taken)
    assert P.METRICS.snapshot()["gauges"]["serving.queue.depth"] == 0


# ------------------------------------------- warm-gated ring admission
def _warmable(P, name, warmed=True):
    class WarmableReplica(P.Replica):
        """Stub whose healthz mirrors the engine's warmed flag."""

        def __init__(self):
            super().__init__(name)
            self.warmed = warmed
            self.closed = False

        def generate(self, payload, timeout_s):
            return {"tokens": [1], "finish_reason": "length",
                    "latency_s": 0.0, "ttft_s": 0.0}

        def healthz(self, timeout_s):
            return {"ok": True, "engine": {"warmed": self.warmed}}

        def close(self):
            self.closed = True

    return WarmableReplica()


def _router(P, reps):
    return P.PrefixRouter(reps, P.RouterConfig(page_size=4, affinity_pages=2))


def test_scale_up_gates_ring_admission_on_warmed(P):
    router = _router(P, [_warmable(P, "r0")])
    cold = _warmable(P, "r1", warmed=False)
    admitted_at = []

    def admit():
        router.scale_up(cold, warm_timeout_s=5.0, poll_s=0.005)
        admitted_at.append(time.monotonic())

    t = threading.Thread(target=admit)
    t0 = time.monotonic()
    t.start()
    time.sleep(0.08)
    assert router.pool.names() == ["r0"]
    cold.warmed = True
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert admitted_at and admitted_at[0] - t0 >= 0.08
    assert set(router.pool.names()) == {"r0", "r1"}
    assert router.pool.is_active("r1")
    assert "r1" in set(router.ring.walk("any-key"))
    assert P.METRICS.snapshot()["gauges"]["router.pool_size"] == 2.0


def test_scale_up_warm_timeout_fails_safe(P):
    router = _router(P, [_warmable(P, "r0")])
    cold = _warmable(P, "r1", warmed=False)
    with pytest.raises(TimeoutError, match="refusing ring admission"):
        router.scale_up(cold, warm_timeout_s=0.05, poll_s=0.005)
    assert cold.closed
    assert router.pool.names() == ["r0"]


def test_scale_down_drains_then_removes(P):
    reps = [_warmable(P, f"r{i}") for i in range(2)]
    router = _router(P, reps)
    router.pool.begin_request("r1")
    with pytest.raises(TimeoutError, match="reactivated"):
        router.scale_down("r1", drain_timeout_s=0.05, poll_s=0.005)
    assert router.pool.is_active("r1")
    assert set(router.pool.names()) == {"r0", "r1"}
    router.pool.end_request("r1")
    rep = router.scale_down("r1", drain_timeout_s=1.0, poll_s=0.005)
    assert rep is reps[1]
    assert router.pool.names() == ["r0"]
    assert "r1" not in set(router.ring.walk("any-key"))
    snap = P.METRICS.snapshot()["counters"]
    assert snap["router.drain_aborts"] == 1
    assert snap["router.scale_down"] == 1


def test_scale_down_refuses_last_replica(P):
    router = _router(P, [_warmable(P, "r0")])
    with pytest.raises(RuntimeError, match="last replica"):
        router.scale_down("r0")


def test_autoscaler_over_real_router_seams(P):
    """Burn scales the router up by a warmed replica, a quiet window
    drains one back down, and the chaos kill freezes membership."""
    seq = [1]
    router = _router(P, [_warmable(P, "r0")])

    def factory():
        name = f"r{seq[0]}"
        seq[0] += 1
        return _warmable(P, name)

    cfg = P.AutoscalerConfig(cooldown_s=0.0, down_consecutive=1,
                             max_replicas=3, warm_timeout_s=1.0,
                             drain_timeout_s=1.0)
    up, down, size = P.router_actuators(router, factory, cfg)
    clock = _Clock()
    feed = []
    scaler = P.Autoscaler(lambda: feed.pop(0), up, down, size, cfg=cfg,
                          clock=clock)
    feed.append(burning(P))
    clock.tick(1)
    assert scaler.step() == "up" and size() == 2
    feed.append(quiet(P))
    clock.tick(1)
    assert scaler.step() == "down" and size() == 1
    with P.inject_faults(P.FaultSpec("control.autoscaler", probability=1.0)):
        feed.append(burning(P))
        clock.tick(1)
        assert scaler.step() is None
    assert scaler.dead and size() == 1
    assert router.pool.is_active("r0")


def test_router_signals_reads_real_evaluators(P):
    reg = P.obs.MetricsRegistry()
    store = P.obs.TimeSeriesStore(registry=reg)
    obj = P.obs.SLObjective("ttft", "upper", "serving.ttft.p99", 0.5,
                            budget=0.05, windows=(8.0, 16.0))
    slo = P.obs.SLOEvaluator([obj], store, registry=reg,
                             breach_cooldown_s=1e9)
    fore = P.obs.ForecastEvaluator([obj], store, registry=reg,
                                   horizon_s=30.0, window_s=8.0,
                                   min_samples=4, breach_cooldown_s=1e9)
    queue = P.RequestQueue(max_depth=8)
    read = P.router_signals(slo, queue, "ttft", forecast=fore)
    sig = read()
    assert sig.burn is None and sig.queue_depth == 0 and sig.ttb_s is None
    t = 0.0
    while t <= 20.0:
        reg.gauge("serving.ttft.p99", 0.1 + 0.04 * t)
        store.sample_once(t=t)
        t += 0.5
    queue.submit(P.GenerateRequest(prompt=[1], max_new_tokens=1))
    sig = read()
    assert sig.burn is not None and sig.burn > 0
    assert sig.queue_depth == 1
    assert sig.ttb_s is not None and sig.ttb_s < 30.0
    assert fore.ttb_seconds("no-such-objective") is None


def test_wave_actuators_name_the_multi_device_item():
    with pytest.raises(NotImplementedError, match="A10"):
        tauto.wave_actuators(object())
