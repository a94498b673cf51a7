"""The port's multi-PROCESS scaleout runtime (``parallel.procrunner`` over
the file state plane of ``parallel.procstate``) against the JAX
package's, after ``tests/test_multiprocess.py``:

1. OS-process workers (``python -m
   deeplearning4j_tpu_torch.parallel.worker_main``) run the distributed
   word count; the Counter equals the reference's exactly.
2. The file state plane round-trips across reopens, and a file written by
   one package's plane reads in the other's.
3. SIGKILL a worker process mid-run: the master evicts it by heartbeat
   staleness, re-routes its job, and the final model equals an
   uninterrupted single-worker run of both packages (the reference's
   margins: a 1 s eviction timeout, a 90 s wall).
4. The svmlight superstep: two workers train on byte-range splits of one
   file; the averaged weights equal the reference's superstep within
   1e-6 (float64, the same waves).

The workers run ``chip_smoke.py``'s probed performers (spec
``chip_smoke:probed_*``, importable from the checkout root on a worker's
path), which record what the worker imported: no ``jax``, no
``deeplearning4j_tpu``, and no CUDA context for these host performers.  The reference's ``jax.distributed`` test has its port
counterpart in the ``initialize_multihost`` tests of
``test_torch_parallel.py``.
"""

import os
import signal
import threading
import time
from collections import Counter

import numpy as np

import deeplearning4j_tpu.parallel.performers as jperf
import deeplearning4j_tpu.parallel.procstate as jps
import deeplearning4j_tpu.parallel.scaleout as jso
import deeplearning4j_tpu_torch.parallel.performers as tperf
import deeplearning4j_tpu_torch.parallel.procstate as tps
import deeplearning4j_tpu_torch.parallel.scaleout as tso
from deeplearning4j_tpu_torch.parallel.procrunner import (
    ProcessDistributedRunner, collect_result, resolve_performer_factory)
from torch_port_obs import port_obs  # noqa: F401  (autouse)
from chip_smoke import _worker_records as read_records

#: one thread a worker process
WORKER_ENV = {"OMP_NUM_THREADS": "1"}
LINES = ["the quick brown fox", "the lazy dog", "the fox jumps",
         "over the lazy dog", "quick quick brown"]


def _assert_clean_workers(state, n_min):
    recs = read_records(state)
    assert len(recs) >= n_min, recs
    for r in recs:
        assert r["forbidden"] == [], r
        assert r["cuda_initialized"] is False, r
        assert r["main"] == "deeplearning4j_tpu_torch.parallel.worker_main"


def test_process_runner_word_count(tmp_path):
    """The reference's distributed word-count example on OS-process
    workers: the exact Counter, equal to the reference's thread runner's
    on the same lines."""
    state = tmp_path / "state"
    runner = ProcessDistributedRunner(
        tso.CollectionJobIterator(LINES), "chip_smoke:probed_slow_word_count",
        state_dir=state, n_workers=2, router_cls=tperf.WordCountRouter,
        worker_env=WORKER_ENV)
    result = runner.run(max_wall_s=60.0)
    assert result == Counter(" ".join(LINES).split())
    ref = jso.DistributedRunner(
        jso.CollectionJobIterator(LINES), jperf.WordCountPerformer,
        n_workers=2, router_cls=jperf.WordCountRouter).run(max_wall_s=60.0)
    assert result == ref
    assert collect_result(state) == result
    # updates really spilled through the file plane
    assert (state / "updates").is_dir()
    _assert_clean_workers(state, 2)
    assert all(p.poll() is not None for p in runner.worker_processes())


def test_file_state_plane_roundtrips(tmp_path):
    """FileUpdateSaver / FileWorkRetriever / FileStateTracker behave like
    their in-memory counterparts across reopens (restart survival)."""
    saver = tps.FileUpdateSaver(tmp_path / "u")
    saver.save("w0", {"a": np.arange(3)})
    reloaded = tps.FileUpdateSaver(tmp_path / "u").load("w0")
    np.testing.assert_array_equal(reloaded["a"], np.arange(3))

    retr = tps.FileWorkRetriever(tmp_path / "s")
    retr.save("w0", tso.Job(work=7.0, worker_id="w0"))
    assert tps.FileWorkRetriever(tmp_path / "s").load("w0").work == 7.0

    t = tps.FileStateTracker(tmp_path / "t")
    t.add_worker("w0")
    t.set_current(np.ones(2))
    t.add_job(tso.Job(work=1.0, worker_id="w0"))
    t2 = tps.FileStateTracker(tmp_path / "t")      # a different "process"
    assert t2.workers() == ["w0"]
    assert t2.needs_replicate("w0")
    np.testing.assert_array_equal(t2.get_current(), np.ones(2))
    assert t2.job_for("w0").work == 1.0
    t2.clear_job("w0")
    assert t.job_for("w0") is None
    assert t.load_for_worker("w0").work == 1.0  # WorkRetriever persistence
    # the reference's directory layout
    assert sorted(p.name for p in t.dir.iterdir() if p.is_dir()) == sorted(
        p.name for p in jps.FileStateTracker(tmp_path / "j").dir.iterdir())


def test_file_plane_carries_tensors_as_numpy(tmp_path):
    """An update or model holding tensors crosses the plane as numpy (no
    reader needs torch's device to unpickle it), and the reference's
    plane reads the port's files."""
    import torch

    t = tps.FileStateTracker(tmp_path)
    t.add_worker("w0")
    t.add_update("w0", {"w": torch.arange(4.0), "n": 3})
    t.set_current([torch.ones(2, dtype=torch.bfloat16)])
    upd = jps.FileStateTracker(tmp_path).updates()["w0"]
    assert isinstance(upd["w"], np.ndarray) and upd["n"] == 3
    np.testing.assert_array_equal(upd["w"], np.arange(4.0))
    cur = jps.FileStateTracker(tmp_path).get_current()
    assert cur[0].dtype == np.float32
    t.record_failure("w0", tso.Job(work="x", worker_id="w0"), "boom")
    assert t.has_failures()
    (wid, job, err), = t.take_failed()
    assert (wid, job.work, err, job.last_error) == ("w0", "x", "boom", "boom")
    t.quarantine(job)
    assert [j.work for j in t.quarantined()] == ["x"]
    t.increment("c", 2)
    t.increment("c", 3)
    assert t.count("c") == 5.0 == jps.FileStateTracker(tmp_path).count("c")


def test_performer_spec_resolves_the_ports_classes():
    f = resolve_performer_factory(
        "deeplearning4j_tpu_torch.parallel.performers:WordCountPerformer")
    assert f is tperf.WordCountPerformer


def _delta_run(so, perf, jobs):
    tracker = so.StateTracker()
    tracker.set_current(np.zeros(perf.VectorDeltaPerformer.dim))
    runner = so.DistributedRunner(
        so.CollectionJobIterator(jobs), perf.VectorDeltaPerformer,
        n_workers=1, tracker=tracker)
    return np.asarray(runner.run(max_wall_s=60.0))


def test_sigkill_worker_process_recovery_parity(tmp_path):
    """Kill a worker with SIGKILL mid-run; the master evicts it by
    heartbeat staleness, re-routes the orphan from the file plane, and the
    final model matches the uninterrupted single-worker run (of both
    packages)."""
    jobs = [1.0, 2.0, 3.0, 4.0, 5.0]
    ref = _delta_run(jso, jperf, jobs)
    np.testing.assert_array_equal(_delta_run(tso, tperf, jobs), ref)

    state = tmp_path / "state"
    runner = ProcessDistributedRunner(
        tso.CollectionJobIterator(jobs),
        "deeplearning4j_tpu_torch.parallel.performers:"
        "SlowVectorDeltaPerformer",
        state_dir=state, n_workers=2, eviction_timeout_s=1.0,
        worker_env=WORKER_ENV)
    runner.tracker.set_current(np.zeros(tperf.VectorDeltaPerformer.dim))

    killed = {}

    def assassin():
        # wait until worker-0 has a job in flight, then SIGKILL its process
        deadline = time.time() + 30.0
        while time.time() < deadline:
            if (state / "jobs" / "worker-0").exists() and runner.worker_processes():
                proc = runner.worker_processes()[0]
                os.kill(proc.pid, signal.SIGKILL)
                killed["pid"] = proc.pid
                return
            time.sleep(0.02)

    t = threading.Thread(target=assassin, daemon=True)
    t.start()
    result = runner.run(max_wall_s=90.0)
    t.join(timeout=5.0)

    assert "pid" in killed, "assassin never fired"
    assert "worker-0" not in runner.tracker.workers()   # evicted
    assert runner.tracker.is_done()
    np.testing.assert_allclose(np.asarray(result), ref, atol=1e-12)


def _svmlight_jobs(tmp_path, save_svmlight):
    rng = np.random.default_rng(3)
    n, d, c = 200, 6, 2
    labels = rng.integers(0, c, n)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    feats += 2.5 * labels[:, None] * np.eye(d, dtype=np.float32)[0]
    feats[:, -1] = 1.0            # bias column (the model has no intercept)
    path = tmp_path / "corpus.svmlight"
    save_svmlight(path, feats, labels)
    size = path.stat().st_size
    # 2 splits x 6 epochs of superstep jobs
    splits = [(0, size // 2), (size // 2, size)]
    jobs = [f"{path}::{s}::{e}::{d}::{c}"
            for _ in range(6) for (s, e) in splits]
    return path, jobs, d, c


def test_process_superstep_trains_from_svmlight_splits(tmp_path):
    """The IRUnit pattern end to end (IRUnitSVMLightWorkerTest analog):
    OS-process workers each train on a byte-range split of ONE svmlight
    file across parameter-averaging supersteps; the averaged model must
    classify the corpus and equal the reference's superstep (two splits a
    wave, averaged) within 1e-6."""
    from deeplearning4j_tpu_torch.datasets.svmlight import (load_svmlight,
                                                            save_svmlight)

    path, jobs, d, c = _svmlight_jobs(tmp_path, save_svmlight)
    state = tmp_path / "state"
    runner = ProcessDistributedRunner(
        tso.CollectionJobIterator(jobs), "chip_smoke:probed_svmlight",
        state_dir=state, n_workers=2, worker_env=WORKER_ENV)
    w = np.asarray(runner.run(max_wall_s=120.0)).reshape(d, c)

    x, y = load_svmlight(path, d, c)
    acc = (np.argmax(x @ w, -1) == y.argmax(-1)).mean()
    assert acc > 0.9, f"superstep-trained softmax accuracy {acc}"

    want = jso.DistributedRunner(
        jso.CollectionJobIterator(jobs), jperf.SVMLightTrainPerformer,
        n_workers=2).run(max_wall_s=120.0)
    assert w.dtype == np.float64
    np.testing.assert_allclose(w.reshape(-1), want, rtol=0, atol=1e-6)
    _assert_clean_workers(state, 2)


def test_wave_grows_and_retires_process_workers(tmp_path):
    """``wave_actuators`` over the process runner, under its default 2 s
    eviction timeout: a worker admitted mid-run (its interpreter's torch
    import takes ~3 s here, longer under load) is kept alive until its
    boot marker appears, then takes jobs; an idle worker is retired; the
    count stays exact."""
    from deeplearning4j_tpu_torch.control.autoscaler import wave_actuators

    lines = [f"w{i % 7} w{i % 3} x" for i in range(60)]
    state = tmp_path / "state"
    runner = ProcessDistributedRunner(
        tso.CollectionJobIterator(lines),
        "chip_smoke:probed_slow_word_count", state_dir=state,
        n_workers=2, router_cls=tperf.WordCountRouter,
        worker_env=WORKER_ENV)
    up, down, size = wave_actuators(runner)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        result=runner.run(max_wall_s=120.0)), daemon=True)
    t.start()
    deadline = time.time() + 60.0
    while not runner.tracker.current_jobs() and time.time() < deadline:
        time.sleep(0.02)
    up()
    new = runner._spawned_wids[-1]
    assert size() == 3
    while not (state / "boot" / new).exists() and time.time() < deadline:
        time.sleep(0.05)
    retired = None
    while retired is None and time.time() < deadline:
        retired = runner.retire_worker()
        time.sleep(0.02)
    t.join(timeout=120.0)
    assert not t.is_alive() and out["result"] == Counter(
        " ".join(lines).split())
    assert retired is not None and size() == 2
    assert new in runner.tracker.workers()          # never evicted
    _assert_clean_workers(state, 3)
