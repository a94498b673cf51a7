"""The port's scaleout control plane (``parallel.scaleout``) and artifact
storage (``parallel.storage``) against the JAX package's.

The battery of ``tests/test_scaleout.py`` (the reference's
``BaseTestDistributed`` pattern: the real tracker + router + master loop
+ worker threads in one process) runs once per package (``P``) with the
same expectations.  The ``*_equal_the_reference`` tests replay seeded
sequences through both packages and hold the outcomes equal: the
aggregator's averages exactly (float64 sums in the same order), the
routers' dispatch decisions step by step, and the eviction and
quarantine of the same jobs.  The storage cases of
``tests/test_subsystems.py`` run per package, and a registry written by
one package reads back in the other.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.parallel.scaleout as jso
import deeplearning4j_tpu.parallel.storage as jst
import deeplearning4j_tpu_torch.parallel.scaleout as tso
import deeplearning4j_tpu_torch.parallel.storage as tst
from torch_port_obs import port_obs  # noqa: F401  (autouse)

PKGS = {"port": SimpleNamespace(so=tso, st=tst),
        "reference": SimpleNamespace(so=jso, st=jst)}


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


class NoOpPerformer:
    """``TestPerformer.java`` — records jobs, produces no updates."""

    performed = []

    def __init__(self, tracker):
        self.tracker = tracker

    def perform(self, job):
        NoOpPerformer.performed.append(job.work)

    def update(self, *args):
        pass


class AveragingPerformer:
    """Produce the work array as the 'trained params' update; master
    averages them (parameter-averaging superstep in miniature)."""

    def __init__(self, tracker):
        self.tracker = tracker
        self.received_model = None

    def perform(self, job):
        job.result = np.asarray(job.work, dtype=np.float64)

    def update(self, current):
        self.received_model = current


# ------------------------------------------------------------------ battery

def test_state_tracker_basics(P):
    t = P.so.StateTracker()
    t.add_worker("w0")
    t.add_worker("w1")
    assert t.workers() == ["w0", "w1"]
    t.disable_worker("w1")
    assert t.is_enabled("w0") and not t.is_enabled("w1")
    t.add_job(P.so.Job(work=1, worker_id="w0"))
    assert t.job_for("w0").work == 1
    assert t.load_for_worker("w0").work == 1  # persisted for re-retrieval
    t.clear_job("w0")
    assert t.job_for("w0") is None
    t.increment("words", 10)
    t.increment("words", 5)
    assert t.count("words") == 15
    t.add_update("w0", np.ones(3))
    assert "w0" in t.updates()


def test_heartbeat_eviction(P):
    t = P.so.StateTracker()
    t.add_worker("alive")
    t.add_worker("dead")
    t._heartbeats["dead"] = time.time() - 1000
    t.add_job(P.so.Job(work="orphan-work", worker_id="dead"))
    evicted, orphans = t.evict_stale(timeout_s=120)
    assert evicted == ["dead"]
    assert [j.work for j in orphans] == ["orphan-work"]
    assert t.workers() == ["alive"]


def test_update_listener_fires(P):
    t = P.so.StateTracker()
    seen = []
    t.update_listeners.append(seen.append)
    t.add_update("w0", 42)
    assert seen == [42]


def test_array_aggregator_running_average(P):
    agg = P.so.ArrayAggregator()
    agg.accumulate(P.so.Job(work=None, result=np.array([2.0, 4.0])))
    agg.accumulate(P.so.Job(work=None, result=np.array([4.0, 8.0])))
    np.testing.assert_allclose(agg.aggregate(), [3.0, 6.0])


def test_routers_policy(P):
    t = P.so.StateTracker()
    t.add_worker("w0")
    t.add_worker("w1")
    ir = P.so.IterativeReduceWorkRouter(t)
    hw = P.so.HogWildWorkRouter(t)
    assert hw.send_work()
    assert not ir.send_work()          # no updates yet
    t.add_update("w0", np.ones(2))
    assert not ir.send_work()          # 1 of 2
    t.add_update("w1", np.ones(2))
    assert ir.send_work()              # all reported


def test_runner_orchestration_noop(P):
    NoOpPerformer.performed = []
    runner = P.so.DistributedRunner(
        P.so.CollectionJobIterator(list(range(20))), NoOpPerformer,
        n_workers=3)
    runner.run(max_wall_s=30)
    assert sorted(NoOpPerformer.performed) == list(range(20))
    assert runner.tracker.is_done()


def test_runner_parameter_averaging(P, tmp_path):
    """End-to-end superstep: workers 'train' (echo arrays), master averages
    via IterativeReduce policy and persists via ModelSaver."""
    items = [np.full(4, float(i)) for i in range(8)]
    saver = P.so.FileModelSaver(tmp_path / "model.bin")
    runner = P.so.DistributedRunner(
        P.so.CollectionJobIterator(items), AveragingPerformer, n_workers=2,
        router_cls=P.so.IterativeReduceWorkRouter, model_saver=saver)
    result = runner.run(max_wall_s=30)
    assert result is not None and result.shape == (4,)
    # final current model is an average of (subsets of) the items
    assert 0.0 <= float(result[0]) <= 7.0
    np.testing.assert_allclose(saver.load(), result)


def test_runner_hogwild_always_dispatches(P):
    items = [np.ones(2) * i for i in range(6)]
    runner = P.so.DistributedRunner(
        P.so.CollectionJobIterator(items), AveragingPerformer, n_workers=2,
        router_cls=P.so.HogWildWorkRouter)
    result = runner.run(max_wall_s=30)
    assert runner.tracker.is_done()
    assert result is not None


def test_run_deadline_raises_with_the_partial_model(P):
    """A run that hits ``max_wall_s`` with work outstanding raises
    ``ScaleoutTimeout`` carrying the current model (or returns it with
    ``on_timeout='return'``)."""
    gate = threading.Event()

    class Stuck:
        def __init__(self, tracker):
            pass

        def perform(self, job):
            gate.wait(timeout=10.0)

        def update(self, *a):
            pass

    tracker = P.so.StateTracker()
    tracker.set_current(np.arange(3.0))
    runner = P.so.DistributedRunner(
        P.so.CollectionJobIterator([1, 2]), Stuck, n_workers=1,
        tracker=tracker)
    try:
        with pytest.raises(P.so.ScaleoutTimeout) as e:
            runner.run(max_wall_s=0.3)
    finally:
        gate.set()
    np.testing.assert_array_equal(e.value.partial, np.arange(3.0))
    with pytest.raises(ValueError, match="on_timeout"):
        P.so.DistributedRunner(P.so.CollectionJobIterator([]), Stuck,
                               on_timeout="ignore")


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_poison_job_is_quarantined_and_the_run_completes(P):
    """A job that fails every attempt is quarantined after
    ``max_job_attempts``; its worker dies each time and is respawned, and
    the other jobs' results still aggregate."""
    class Poisoned:
        def __init__(self, tracker):
            self.tracker = tracker

        def perform(self, job):
            if job.work == "poison":
                raise ValueError("bad record")
            job.result = np.full(2, float(job.work))

        def update(self, *a):
            pass

    runner = P.so.DistributedRunner(
        P.so.CollectionJobIterator([1.0, "poison", 3.0]), Poisoned,
        n_workers=1, max_job_attempts=2, max_respawns=3,
        router_cls=P.so.HogWildWorkRouter)
    runner.run(max_wall_s=30)
    q = runner.tracker.quarantined()
    assert [j.work for j in q] == ["poison"] and q[0].attempts == 2
    assert "bad record" in q[0].last_error


def test_retired_worker_takes_no_job_and_the_wave_completes():
    """Workers retired mid-run under the synchronous word-count router,
    as fast as the wave lets them: the master hands a retired worker no
    further job, the wave stops waiting for it, its pending update does
    not close a wave early, and every job's count arrives exactly once.
    (The reference still hands the parked worker a job and counts it in
    the wave: its run stalls to the deadline, so only the port runs
    this.)"""
    from collections import Counter

    from deeplearning4j_tpu_torch.parallel.performers import (
        WordCountPerformer, WordCountRouter)

    class Slow(WordCountPerformer):
        def perform(self, job):
            time.sleep(0.01)
            super().perform(job)

    lines = [f"a b{i % 5} c{i % 3}" for i in range(60)]
    runner = tso.DistributedRunner(
        tso.CollectionJobIterator(lines), Slow, n_workers=4,
        router_cls=WordCountRouter, poll_s=0.002)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        result=runner.run(max_wall_s=30)), daemon=True)
    t.start()
    retired, deadline = [], time.time() + 20
    while len(retired) < 2 and time.time() < deadline and t.is_alive():
        w = runner.retire_worker()
        if w is not None:
            retired.append(w)
        time.sleep(0.001)
    t.join(timeout=30)
    assert len(retired) == 2 and not t.is_alive()
    assert out["result"] == Counter(" ".join(lines).split())
    assert all(runner.tracker.job_for(w) is None for w in retired)


def test_a_worker_finishing_mid_dispatch_is_not_handed_a_job():
    """A worker that posts its update and clears its job while the master
    dispatches is not handed its next job before the merge (which would
    run it on the old model and overwrite the first update): the master
    reads the jobs before the pending updates.  The tracker below makes
    w0 finish exactly between the two reads."""
    class Finishing(tso.StateTracker):
        def job_for(self, worker_id):
            job = super().job_for(worker_id)
            if worker_id == "w0" and job is not None and job.work == "J":
                self.add_update("w0", np.ones(2))   # the worker's order
                self.clear_job("w0")
                return None
            return job

    t = Finishing()
    t.add_worker("w0")
    t.add_job(tso.Job(work="J", worker_id="w0"))
    runner = tso.DistributedRunner(tso.CollectionJobIterator(["K"]),
                                   AveragingPerformer, tracker=t)
    assert runner._dispatch([]) is False
    assert t.job_for("w0") is None and "w0" in t.updates()


# ------------------------------------------------------------------ parity

def _tree(rng, torch_leaves=False):
    leaf = (lambda a: torch.from_numpy(a)) if torch_leaves else (lambda a: a)
    return {"w": leaf(rng.standard_normal((3, 4))),
            "layers": [leaf(rng.standard_normal(5)),
                       (leaf(rng.standard_normal((2, 2))),
                        leaf(rng.standard_normal(1)))]}


def test_array_aggregator_equals_the_reference():
    """The same seeded trees, summed and averaged by both packages: equal
    bit for bit (float64, same order); the port takes tensor leaves too
    and returns numpy."""
    seeds = range(5)
    want = jso.ArrayAggregator()
    got = tso.ArrayAggregator()
    got_t = tso.ArrayAggregator()
    for s in seeds:
        want.accumulate(jso.Job(work=None,
                                result=_tree(np.random.default_rng(s))))
        got.accumulate(tso.Job(work=None,
                               result=_tree(np.random.default_rng(s))))
        got_t.accumulate(tso.Job(work=None, result=_tree(
            np.random.default_rng(s), torch_leaves=True)))
    w = want.aggregate()
    for g in (got.aggregate(), got_t.aggregate()):
        assert isinstance(g["layers"][1], tuple)
        for a, b in zip(tso.tree_leaves(g), tso.tree_leaves(w)):
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, np.asarray(b))
    assert tso.ArrayAggregator().aggregate() is None


def test_to_host_moves_only_tensors():
    from collections import Counter

    c = Counter("aab")
    assert tso.to_host(c) is c
    tree = {"a": torch.ones(2, dtype=torch.bfloat16), "b": [np.zeros(1), 3]}
    out = tso.to_host(tree)
    assert out["a"].dtype == np.float32 and out["b"][1] == 3
    assert isinstance(tso.to_host(torch.arange(3)), np.ndarray)


def test_router_decisions_equal_the_reference():
    """A seeded random sequence of joins, leaves, updates and merges
    through both packages' trackers: every step, both routers decide
    alike, and the merged model is equal.  The sequence keeps to what a
    run produces: updates come from registered workers, and a worker
    leaves with no update pending (a stale update is where the packages
    part: ``test_a_stale_update_does_not_close_the_wave``)."""
    rng = np.random.default_rng(0)
    trackers = [jso.StateTracker(), tso.StateTracker()]
    routers = [(jso.IterativeReduceWorkRouter(trackers[0]),
                jso.HogWildWorkRouter(trackers[0])),
               (tso.IterativeReduceWorkRouter(trackers[1]),
                tso.HogWildWorkRouter(trackers[1]))]
    decisions = [[], []]
    for step in range(300):
        op = rng.integers(0, 5)
        w = f"w{rng.integers(0, 4)}"
        upd = rng.standard_normal(3)
        registered = w in trackers[0].workers()
        pending = w in trackers[0].updates()
        for i, t in enumerate(trackers):
            if op == 0:
                t.add_worker(w)
            elif op == 1 and not pending:
                t.remove_worker(w)
            elif op in (2, 3) and registered:
                t.add_update(w, upd)
            ir, hw = routers[i]
            sent = ir.send_work()
            if op == 4 and sent:
                ir.update()
            decisions[i].append((sent, hw.send_work(), tuple(t.workers()),
                                 tuple(sorted(t.updates()))))
    assert decisions[0] == decisions[1]
    assert sum(d[0] for d in decisions[1]) > 10
    np.testing.assert_array_equal(trackers[1].get_current(),
                                  trackers[0].get_current())


def test_a_stale_update_does_not_close_the_wave():
    """The port's synchronous wave waits for every enabled worker: the
    pending update of a retired or departed worker does not stand in for
    a live worker still mid-job.  (The reference counts updates: after a
    departure it merges with the live worker mid-job, and its clear-all
    then drops that worker's update arriving during the merge.)  A merge
    clears only what it merged."""
    for retire in (True, False):
        t = tso.StateTracker()
        for w in ("w0", "w1", "w2"):
            t.add_worker(w)
        t.add_update("w2", np.ones(2))
        if retire:
            t.disable_worker("w2")
        else:
            t.remove_worker("w2")
        t.add_update("w0", np.ones(2))
        ir = tso.IterativeReduceWorkRouter(t)
        assert not ir.send_work()              # w1 still mid-job
        t.add_update("w1", np.ones(2))
        assert ir.send_work()
    j = jso.StateTracker()
    for w in ("w0", "w1", "w2"):
        j.add_worker(w)
    j.add_update("w2", np.ones(2))
    j.remove_worker("w2")
    j.add_update("w0", np.ones(2))
    assert jso.IterativeReduceWorkRouter(j).send_work()   # w1 mid-job
    t.clear_updates(["w0"])
    assert sorted(t.updates()) == ["w1", "w2"]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_eviction_and_quarantine_equal_the_reference():
    """The same heartbeat layout evicts the same workers and orphans the
    same jobs; the same job sequence through a one-worker runner with a
    poison job quarantines the same job after the same attempts and ends
    on the same model."""
    rng = np.random.default_rng(3)
    ages = rng.uniform(0, 200, 8)
    out = []
    for so in (jso, tso):
        t = so.StateTracker()
        now = time.time()
        for i, age in enumerate(ages):
            t.add_worker(f"w{i}")
            t._heartbeats[f"w{i}"] = now - age
            if i % 2:
                t.add_job(so.Job(work=i, worker_id=f"w{i}"))
        evicted, orphans = t.evict_stale(timeout_s=120)
        out.append((evicted, [j.work for j in orphans], t.workers()))
    assert out[0] == out[1] and out[0][0]

    class Delta:
        def __init__(self, tracker):
            self.tracker = tracker

        def perform(self, job):
            if job.work < 0:
                raise ValueError("poison")
            cur = self.tracker.get_current()
            job.result = np.asarray(cur) + float(job.work)

        def update(self, *a):
            pass

    results = []
    for so in (jso, tso):
        tracker = so.StateTracker()
        tracker.set_current(np.zeros(3))
        runner = so.DistributedRunner(
            so.CollectionJobIterator([1.0, -1.0, 2.0, 3.0]), Delta,
            n_workers=1, tracker=tracker, max_job_attempts=3,
            max_respawns=5)
        model = runner.run(max_wall_s=30)
        q = tracker.quarantined()
        results.append((model, [(j.work, j.attempts) for j in q],
                        runner._respawned))
    np.testing.assert_array_equal(results[1][0], results[0][0])
    assert results[1][1:] == results[0][1:] == ([(-1.0, 3)], 3)


# ------------------------------------------------------------------ storage

def test_local_store_and_registry(P, tmp_path):
    store = P.st.LocalArtifactStore(tmp_path)
    store.put_bytes("a/b.bin", b"hello")
    assert store.exists("a/b.bin")
    assert store.get_bytes("a/b.bin") == b"hello"
    assert store.list() == ["a/b.bin"]
    with pytest.raises(ValueError):
        store.put_bytes("../escape", b"x")

    saver = P.st.StoreModelSaver(store, "m.pkl")
    saver.save({"w": [1, 2]})
    assert saver.load() == {"w": [1, 2]}

    reg = P.st.ConfigRegistry(store)
    reg.register("host1", "training", {"lr": 0.1})
    assert reg.exists("host1", "training")
    assert reg.retrieve("host1", "training") == {"lr": 0.1}
    assert reg.hosts() == ["host1"]
    reg.unregister("host1", "training")
    assert not reg.exists("host1", "training")
    store.delete("a")
    assert store.list() == ["m.pkl"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_registry_reads_across_packages(tmp_path, writer):
    """A registry (and a saved model) written by one package read back by
    the other: the same keys, documents and bytes."""
    w, r = PKGS[writer], PKGS["reference" if writer == "port" else "port"]
    cfg = {"lr": 0.1, "layers": [768, 3072], "name": "leg-a", "zero": 1}
    reg = w.st.ConfigRegistry(w.st.LocalArtifactStore(tmp_path), "cluster")
    reg.register("host-b", "train", cfg)
    reg.register("host-a", "serve", {"slots": 8})
    w.st.save_model(w.st.LocalArtifactStore(tmp_path), "models/m.pkl",
                    {"w": np.arange(4.0)})
    back = r.st.ConfigRegistry(r.st.LocalArtifactStore(tmp_path), "cluster")
    assert back.hosts() == ["host-a", "host-b"]
    assert back.retrieve("host-b", "train") == cfg
    store_w = w.st.LocalArtifactStore(tmp_path)
    store_r = r.st.LocalArtifactStore(tmp_path)
    assert store_r.list() == store_w.list()
    assert store_r.get_bytes("cluster/host-b/train.json") == \
        store_w.get_bytes("cluster/host-b/train.json")
    np.testing.assert_array_equal(
        r.st.load_model(store_r, "models/m.pkl")["w"], np.arange(4.0))


def test_gcs_store_without_its_client_fails_as_the_reference(monkeypatch):
    """Without ``google.cloud.storage`` both packages refuse a GCS store
    with the same RuntimeError, before any network call."""
    import builtins

    real = builtins.__import__

    def no_gcs(name, *a, **kw):
        if name.startswith("google"):
            raise ImportError("no google-cloud-storage here")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_gcs)
    msgs = []
    for st in (jst, tst):
        with pytest.raises(RuntimeError, match="LocalArtifactStore") as e:
            st.GCSArtifactStore("bucket")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_file_model_saver_publishes_whole_pickles(tmp_path):
    """Concurrent saves to one path each publish a complete pickle that
    the reference's saver reads (unique temp files, atomic replace)."""
    path = tmp_path / "m.bin"
    savers = [tso.FileModelSaver(path) for _ in range(4)]
    threads = [threading.Thread(target=s.save, args=(np.full(1000, i),))
               for i, s in enumerate(savers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    got = jso.FileModelSaver(path).load()
    assert got.shape == (1000,) and (got == got[0]).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.bin"]
