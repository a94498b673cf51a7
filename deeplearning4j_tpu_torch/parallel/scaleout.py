"""Host-side scaleout control plane: jobs, performers, state tracking,
routing, and an in-process master/worker runtime.

Port of ``deeplearning4j_tpu/parallel/scaleout.py`` (capability parity
with the reference's L5/L6, SURVEY.md §2.3-2.4):

- ``Job``/``JobIterator`` (``scaleout/job/*.java``) — serializable work units
- ``WorkerPerformer`` SPI (``scaleout/perform/WorkerPerformer.java``)
- ``JobAggregator`` (``scaleout/aggregator/JobAggregator.java``) with the
  running-average ``ArrayAggregator`` (≡ ``INDArrayAggregator``)
- ``StateTracker`` (``scaleout/api/statetracker/StateTracker.java`` ~40-method
  blackboard): workers, heartbeats, jobs, updates, counters, current-model
  replication — an in-process, thread-safe dict replacing Hazelcast
- ``WorkRouter`` policies: ``IterativeReduceWorkRouter`` (dispatch only when
  all workers reported) vs ``HogWildWorkRouter`` (always dispatch)
- ``DistributedRunner`` (``DeepLearning4jDistributed.java``): master loop +
  worker threads with 1 s heartbeats, 120 s stale eviction
  (``MasterActor.java:123-153``), job re-routing, ``ModelSaver`` hooks.

Host code only: numpy, pickle and threads.  The data plane of training is
``torch.distributed`` (``trainer.py``); this is the orchestration layer for
workloads that ship jobs (row-shipping embedding training, grid jobs, the
word-count and svmlight supersteps).  A performer that computes on the
card hands its result back as host arrays: ``ArrayAggregator`` averages
numpy arrays (a tensor result is copied to the host first), so neither the
master nor a file-plane worker needs a CUDA context to read a result.

Repairs against the reference's runner: the master reads the workers'
jobs before their pending updates when it dispatches, so a worker that
finishes meanwhile is not handed its next job before the merge; a worker
retired from the wave (``retire_worker``) is handed no further job (its
check and the master's dispatch exclude each other); the synchronous
wave closes when every enabled worker has reported, not when the count
of updates reaches the count of workers; and a merge clears only the
updates it merged.  In the reference a worker finishing mid-dispatch
runs its next job on the old model and overwrites its first update (a
superstep's average and a word count's total come out wrong), a run
stalls after a retire, a departed worker's pending update closes a wave
with a live worker mid-job, and an update landing during a merge is
dropped.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Protocol, Sequence

import numpy as np

from ..observability import FLIGHTREC, METRICS, trace
from ..resilience.faults import FAULTS, WorkerKilled
from ..utils.tree_math import tree_leaves, tree_map


class ScaleoutTimeout(RuntimeError):
    """``DistributedRunner.run`` hit ``max_wall_s`` with work outstanding.

    ``partial`` carries the tracker's current model at expiry so a caller
    that wants best-effort results can still read them — but the default
    is to RAISE: a run that silently returns half-trained state on
    deadline is indistinguishable from success (DESIGN.md §12).
    """

    def __init__(self, max_wall_s: float, partial: Any = None):
        super().__init__(
            f"scaleout run exceeded max_wall_s={max_wall_s:g}s with jobs "
            "outstanding (partial result attached as .partial)")
        self.partial = partial


# --------------------------------------------------------------------------- jobs

@dataclass
class Job:
    """Serializable work unit (``scaleout/job/Job.java``).

    ``attempts`` counts failed executions (incremented by the master on
    each requeue); at ``max_job_attempts`` the job is quarantined instead
    of re-routed — a poison job cannot take the whole run down with it.
    """

    work: Any
    worker_id: str = ""
    result: Any = None
    job_id: str = ""
    attempts: int = 0
    last_error: str = ""
    # distributed-trace identity: stamped by the master at dispatch, bound
    # on the worker around perform() — one run renders as one flame
    trace_id: str = ""
    parent_span_id: str = ""


class JobIterator(Protocol):
    """``scaleout/job/JobIterator.java``."""

    def next(self, worker_id: str = "") -> Job: ...
    def has_next(self) -> bool: ...
    def reset(self) -> None: ...


class CollectionJobIterator:
    """``scaleout/job/collection/CollectionJobIterator.java``."""

    def __init__(self, items: Sequence[Any]):
        self.items = list(items)
        self._i = 0

    def next(self, worker_id: str = "") -> Job:
        job = Job(work=self.items[self._i], worker_id=worker_id)
        self._i += 1
        return job

    def has_next(self) -> bool:
        return self._i < len(self.items)

    def reset(self) -> None:
        self._i = 0


class DataSetJobIterator:
    """Wrap a DataSetIterator as a job stream (``JobIterator`` over batches)."""

    def __init__(self, it):
        self._it = it

    def next(self, worker_id: str = "") -> Job:
        return Job(work=self._it.next(), worker_id=worker_id)

    def has_next(self) -> bool:
        return self._it.has_next()

    def reset(self) -> None:
        self._it.reset()


# --------------------------------------------------------------------------- SPI

class WorkerPerformer(Protocol):
    """``scaleout/perform/WorkerPerformer.java``: do the work, then push
    updates through ``update``."""

    def perform(self, job: Job) -> None: ...
    def update(self, *args: Any) -> None: ...


class JobAggregator(Protocol):
    """``scaleout/aggregator/JobAggregator.java``."""

    def accumulate(self, job: Job) -> None: ...
    def aggregate(self) -> Any: ...


def _is_tensor(x) -> bool:
    return hasattr(x, "detach") and hasattr(x, "device")


def _host_array(x) -> np.ndarray:
    """A leaf as a host numpy array: a tensor (on any device) is copied to
    the host, half precision widened to float32 (numpy has no bfloat16)."""
    if _is_tensor(x):
        t = x.detach().cpu()
        if t.dtype.is_floating_point and t.element_size() < 4:
            t = t.float()
        return t.numpy()
    return np.asarray(x)


def to_host(result: Any) -> Any:
    """``result`` with every tensor leaf of its dict/list/tuple tree
    copied to the host as numpy; a result without tensors (a ``Counter``,
    numpy arrays, a dataclass) is returned as it is.  What crosses a
    process boundary goes through here, so that unpickling it never needs
    a CUDA context."""
    if _is_tensor(result):
        return _host_array(result)
    if isinstance(result, (dict, list, tuple)) and any(
            _is_tensor(leaf) for leaf in tree_leaves(result)):
        return tree_map(lambda x: _host_array(x) if _is_tensor(x) else x,
                        result)
    return result


class ArrayAggregator:
    """Running average of tree/array results (``INDArrayAggregator``:
    accumulate sum, divide by count on aggregate).  A result is a numpy
    array, a tensor, or a dict/list/tuple tree of them; the sum and the
    average are numpy."""

    def __init__(self):
        self._sum = None
        self._count = 0

    def accumulate(self, job: Job) -> None:
        if job.result is None:
            return
        if self._sum is None:
            self._sum = tree_map(_host_array, job.result)
        else:
            self._sum = tree_map(lambda a, b: a + _host_array(b),
                                 self._sum, job.result)
        self._count += 1

    def aggregate(self) -> Any:
        if self._sum is None:
            return None
        return tree_map(lambda a: a / self._count, self._sum)


# --------------------------------------------------------------------------- state tracker

class StateTracker:
    """In-process cluster blackboard (Hazelcast ``BaseHazelCastStateTracker``
    capability: workers/jobs/updates/heartbeats/counters/current-model).
    Thread-safe; all mutation under one lock (operations are tiny)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._workers: set[str] = set()
        self._enabled: dict[str, bool] = {}
        self._heartbeats: dict[str, float] = {}
        self._jobs: dict[str, Job] = {}          # worker -> current job
        self._updates: dict[str, Any] = {}       # worker -> latest update
        self._counters: dict[str, float] = defaultdict(float)
        self._current: Any = None                # current global model/params
        self._needs_replicate: set[str] = set()
        self._done = False
        self._saved_workers: dict[str, Job] = {} # job persistence for re-retrieval
        self._failed: list[tuple[str, Job, str]] = []   # prompt failure reports
        self._quarantined: list[Job] = []               # poison jobs, retired
        self.update_listeners: list[Callable[[Any], None]] = []

    # -- workers --------------------------------------------------------
    def add_worker(self, worker_id: str) -> None:
        with self._lock:
            self._workers.add(worker_id)
            self._enabled[worker_id] = True
            self._heartbeats[worker_id] = time.time()

    def remove_worker(self, worker_id: str) -> None:
        with self._lock:
            self._workers.discard(worker_id)
            self._enabled.pop(worker_id, None)
            self._heartbeats.pop(worker_id, None)
            self._jobs.pop(worker_id, None)

    def workers(self) -> list[str]:
        with self._lock:
            return sorted(self._workers)

    def enable_worker(self, worker_id: str) -> None:
        with self._lock:
            self._enabled[worker_id] = True

    def disable_worker(self, worker_id: str) -> None:
        with self._lock:
            self._enabled[worker_id] = False

    def is_enabled(self, worker_id: str) -> bool:
        with self._lock:
            return self._enabled.get(worker_id, False)

    # -- heartbeats / failure detection ---------------------------------
    def heartbeat(self, worker_id: str) -> None:
        with self._lock:
            self._heartbeats[worker_id] = time.time()

    def last_heartbeat(self, worker_id: str) -> float:
        with self._lock:
            return self._heartbeats.get(worker_id, 0.0)

    def evict_stale(self, timeout_s: float = 120.0) -> tuple[list[str], list["Job"]]:
        """Master-side eviction sweep (``MasterActor.java:123-153``).

        Returns (evicted worker ids, their orphaned in-flight jobs) so the
        master can re-route the work (``StateTracker.loadForWorker`` parity).
        """
        now = time.time()
        evicted, orphans = [], []
        with self._lock:
            for w in list(self._workers):
                if now - self._heartbeats.get(w, 0) > timeout_s:
                    evicted.append(w)
                    job = self._jobs.get(w)
                    if job is not None:
                        orphans.append(job)
                    self.remove_worker(w)
        return evicted, orphans

    # -- jobs -----------------------------------------------------------
    def add_job(self, job: Job) -> None:
        with self._lock:
            self._jobs[job.worker_id] = job
            self._saved_workers[job.worker_id] = job

    def job_for(self, worker_id: str) -> Job | None:
        with self._lock:
            return self._jobs.get(worker_id)

    def clear_job(self, worker_id: str) -> None:
        with self._lock:
            self._jobs.pop(worker_id, None)

    def current_jobs(self) -> list[Job]:
        with self._lock:
            return list(self._jobs.values())

    def load_for_worker(self, worker_id: str) -> Job | None:
        """Job re-retrieval after worker restart (``WorkRetriever``)."""
        with self._lock:
            return self._saved_workers.get(worker_id)

    # -- failures / quarantine ------------------------------------------
    def record_failure(self, worker_id: str, job: Job, error: str = "") -> None:
        """Prompt failure report from a dying worker: atomically moves the
        job from in-flight to the failed queue, so the master re-routes it
        on the next poll instead of waiting out the heartbeat timeout."""
        with self._lock:
            job.last_error = error
            self._jobs.pop(worker_id, None)
            self._failed.append((worker_id, job, error))

    def take_failed(self) -> list[tuple[str, Job, str]]:
        with self._lock:
            out, self._failed = self._failed, []
            return out

    def has_failures(self) -> bool:
        with self._lock:
            return bool(self._failed)

    def quarantine(self, job: Job) -> None:
        with self._lock:
            self._quarantined.append(job)

    def quarantined(self) -> list[Job]:
        with self._lock:
            return list(self._quarantined)

    # -- updates --------------------------------------------------------
    def add_update(self, worker_id: str, update: Any) -> None:
        with self._lock:
            self._updates[worker_id] = update
            listeners = list(self.update_listeners)
        METRICS.increment("scaleout.updates")
        for l in listeners:
            l(update)

    def updates(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._updates)

    def clear_updates(self, worker_ids=None) -> None:
        """Drop every pending update, or only ``worker_ids``' (those a
        router has just aggregated: one that arrived meanwhile stays)."""
        with self._lock:
            if worker_ids is None:
                self._updates.clear()
            for w in worker_ids or ():
                self._updates.pop(w, None)

    # -- counters (distributed words-seen etc.) -------------------------
    def increment(self, key: str, by: float = 1.0) -> None:
        with self._lock:
            self._counters[key] += by

    def count(self, key: str) -> float:
        with self._lock:
            return self._counters[key]

    # -- current model / replication ------------------------------------
    def set_current(self, value: Any) -> None:
        with self._lock:
            self._current = value
            self._needs_replicate = set(self._workers)

    def get_current(self) -> Any:
        with self._lock:
            return self._current

    def add_replicate(self, worker_id: str) -> None:
        with self._lock:
            self._needs_replicate.add(worker_id)

    def needs_replicate(self, worker_id: str) -> bool:
        with self._lock:
            return worker_id in self._needs_replicate

    def done_replicating(self, worker_id: str) -> None:
        with self._lock:
            self._needs_replicate.discard(worker_id)

    # -- lifecycle ------------------------------------------------------
    def finish(self) -> None:
        with self._lock:
            self._done = True

    def reset_done(self) -> None:
        """Clear a leftover finish flag (a master starting a new run on a
        reused tracker/state dir must not no-op on the previous run's
        DONE)."""
        with self._lock:
            self._done = False

    def is_done(self) -> bool:
        with self._lock:
            return self._done


# --------------------------------------------------------------------------- routers

class WorkRouter:
    """Dispatch/merge policy (``api/workrouter/WorkRouter.java`` +
    ``BaseWorkRouter.java``)."""

    def __init__(self, tracker: StateTracker, aggregator_factory=ArrayAggregator):
        self.tracker = tracker
        self.aggregator_factory = aggregator_factory

    def send_work(self) -> bool:
        raise NotImplementedError

    def update(self) -> None:
        """Aggregate worker updates into the new current model
        (``BaseWorkRouter.update`` → ``IterateAndUpdateImpl``)."""
        updates = self.tracker.updates()
        if not updates:
            return
        agg = self.aggregator_factory()
        for wid, upd in updates.items():
            agg.accumulate(Job(work=None, worker_id=wid, result=upd))
        merged = agg.aggregate()
        if merged is not None:
            self.tracker.set_current(merged)
        # only what was aggregated: an update that lands meanwhile (a
        # hogwild worker, which the reference's clear-all dropped) waits
        # for the next merge
        self.tracker.clear_updates(list(updates))


class IterativeReduceWorkRouter(WorkRouter):
    """Synchronous parameter averaging: only dispatch the next wave after
    every live worker has reported (``IterativeReduceWorkRouter.java:30``).
    Live means enabled: a retired worker takes no jobs, so the wave does
    not wait for it; and every enabled worker must have reported, where
    the reference counts updates (a retired or evicted worker's update
    would then close a wave with a worker still mid-job)."""

    def send_work(self) -> bool:
        live = [w for w in self.tracker.workers()
                if self.tracker.is_enabled(w)]
        updates = self.tracker.updates()
        return bool(live) and all(w in updates for w in live)


class HogWildWorkRouter(WorkRouter):
    """Asynchronous: always dispatch (``HogWildWorkRouter.java``)."""

    def send_work(self) -> bool:
        return True


# --------------------------------------------------------------------------- model saving

class ModelSaver(Protocol):
    """``actor/core/ModelSaver.java``."""

    def save(self, model: Any) -> None: ...
    def load(self) -> Any: ...


class FileModelSaver:
    """``DefaultModelSaver`` — pickle to a file, atomic replace.

    Each save writes a UNIQUE temp file in the target directory (two
    concurrent savers on the same path previously raced on one shared
    ``.tmp`` name — a torn mix of both pickles could be published) and
    fsyncs before the rename, so the published file is always one
    complete, durable pickle.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)

    def save(self, model: Any) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd = tempfile.NamedTemporaryFile(
            dir=self.path.parent, prefix=self.path.name + ".",
            suffix=".tmp", delete=False)
        try:
            with fd as f:
                pickle.dump(model, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(fd.name, self.path)
        except Exception:
            Path(fd.name).unlink(missing_ok=True)
            raise

    def load(self) -> Any:
        with open(self.path, "rb") as f:
            return pickle.load(f)


# --------------------------------------------------------------------------- runner

class DistributedRunner:
    """In-process master/worker runtime (``DeepLearning4jDistributed`` +
    ``MasterActor``/``WorkerActor`` loops).

    Workers = threads pulling jobs via the StateTracker, running the
    WorkerPerformer, heartbeating every ``heartbeat_s``; the master loop
    polls, applies the WorkRouter policy, re-routes orphaned jobs, and
    evicts stale workers.  Mirrors the reference's test pattern: the REAL
    orchestration stack in one process.
    """

    def __init__(self, job_iterator, performer_factory: Callable[[StateTracker], WorkerPerformer],
                 n_workers: int = 2, router_cls=IterativeReduceWorkRouter,
                 tracker: StateTracker | None = None,
                 model_saver: ModelSaver | None = None,
                 heartbeat_s: float = 0.05, poll_s: float = 0.02,
                 eviction_timeout_s: float = 120.0,
                 max_job_attempts: int = 3, job_timeout_s: float = 0.0,
                 max_respawns: int = 0, on_timeout: str = "raise"):
        if on_timeout not in ("raise", "return"):
            raise ValueError(f"on_timeout must be 'raise' or 'return', got {on_timeout!r}")
        self.job_iterator = job_iterator
        self.performer_factory = performer_factory
        self.n_workers = n_workers
        self.tracker = tracker or StateTracker()
        self.router = router_cls(self.tracker)
        self.model_saver = model_saver
        self.heartbeat_s = heartbeat_s
        self.poll_s = poll_s
        self.eviction_timeout_s = eviction_timeout_s
        # resilience knobs (DESIGN.md §12): per-job retry budget before
        # quarantine, optional per-job execution deadline (0 = disabled;
        # enabling it trades exactly-once for at-most-``max_job_attempts``
        # execution — a timed-out worker may still finish concurrently),
        # and a replacement-worker budget (0 = no respawn: the pool only
        # shrinks on failure, which keeps iterative-reduce wave averages
        # comparable across a death; raise it when capacity matters more
        # than wave composition, or when every worker can crash)
        self.max_job_attempts = max(1, max_job_attempts)
        self.job_timeout_s = job_timeout_s
        self.max_respawns = max_respawns
        self.on_timeout = on_timeout
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._dispatched_at: dict[str, float] = {}  # worker -> dispatch time
        # the master's dispatch and a retire's check-then-disable exclude
        # each other: a worker retired as idle is never handed a job
        self._dispatch_lock = threading.Lock()
        self._worker_seq = 0
        self._respawned = 0

    # -- worker loop ----------------------------------------------------
    def _worker_loop(self, worker_id: str):
        performer = self.performer_factory(self.tracker)
        while not self._stop.is_set() and not self.tracker.is_done():
            self.tracker.heartbeat(worker_id)
            if not self.tracker.is_enabled(worker_id):
                time.sleep(self.heartbeat_s)
                continue
            if self.tracker.needs_replicate(worker_id):
                current = self.tracker.get_current()
                if current is not None:
                    performer.update(current)
                self.tracker.done_replicating(worker_id)
            job = self.tracker.job_for(worker_id)
            if job is None:
                time.sleep(self.poll_s)
                continue
            # chaos seams: silent death (thread exits, job still assigned,
            # heartbeats stop — the eviction path must recover) and the
            # straggler simulation (injected sleep before performing)
            FAULTS.maybe_fire("scaleout.worker")
            slow = FAULTS.check("scaleout.worker.slow")
            if slow is not None:
                time.sleep(slow.delay_s)
            try:
                with METRICS.time("scaleout.job"), \
                        trace.bind(job.trace_id, job.parent_span_id), \
                        trace.span("scaleout.perform", worker=worker_id,
                                   attempts=job.attempts):
                    FAULTS.maybe_fire("scaleout.perform")
                    performer.perform(job)
            except WorkerKilled:
                raise            # injected silent death: no failure report
            except Exception as e:
                # prompt failure report: the master re-routes the job on
                # its next poll instead of waiting out the heartbeat
                # timeout; the worker thread still dies (its performer
                # state is suspect) and a replacement is spawned
                self.tracker.record_failure(worker_id, job, repr(e))
                METRICS.increment("scaleout.job_failures")
                raise
            if job.result is not None:
                self.tracker.add_update(worker_id, job.result)
            self.tracker.clear_job(worker_id)
            METRICS.increment("scaleout.jobs_completed")

    # -- worker lifecycle (subclass seam: ProcessDistributedRunner spawns
    #    OS processes here instead of threads) ---------------------------
    def _spawn_one(self, wid: str) -> None:
        self.tracker.add_worker(wid)
        t = threading.Thread(target=self._worker_loop, args=(wid,), daemon=True)
        self._threads.append(t)
        t.start()

    def _spawn_workers(self) -> None:
        for _ in range(self.n_workers):
            wid = f"worker-{self._worker_seq}"
            self._worker_seq += 1
            self._spawn_one(wid)

    def _maybe_respawn(self) -> None:
        """Top the pool back up to ``n_workers`` after deaths/evictions,
        bounded by ``max_respawns`` (a deterministic crash loop must run
        out of budget, not respawn forever).  Once the budget is exhausted
        the wave SHRINKS to the live worker count instead of running with
        a hole: ``IterativeReduceWorkRouter`` and ``ArrayAggregator``
        already key off the live worker set, so superstep averages are
        weighted by the surviving wave, not a fixed composition."""
        live = len(self.tracker.workers())
        while live < self.n_workers and self._respawned < self.max_respawns:
            wid = f"worker-{self._worker_seq}"
            self._worker_seq += 1
            self._respawned += 1
            self._spawn_one(wid)
            METRICS.increment("scaleout.workers_respawned")
            live += 1
        if 0 < live < self.n_workers:
            # a worker stayed dead past its respawn budget — accept the
            # smaller wave (elastic shrink) rather than waiting on a
            # phantom.  (live == 0 is left to the run deadline: there is
            # no wave to shrink to.)
            old = self.n_workers
            self.n_workers = live
            METRICS.increment("scaleout.wave_shrinks")
            METRICS.gauge("elastic.wave_size", live)
            FLIGHTREC.dump("mesh_resize", extra={
                "kind": "scaleout_wave", "direction": "shrink",
                "old_wave": old, "new_wave": live,
                "workers": self.tracker.workers()})

    def register_worker(self, worker_id: str | None = None) -> str:
        """Grow the wave: admit a new (or re-registering) worker into a
        live run.  Raises the target ``n_workers`` so the master expects
        the larger wave, spawns the worker, and notes the resize — the
        inverse of the shrink in :meth:`_maybe_respawn`."""
        wid = worker_id or f"worker-{self._worker_seq}"
        if worker_id is None:
            self._worker_seq += 1
        old = self.n_workers
        self.n_workers += 1
        self._spawn_one(wid)
        METRICS.increment("scaleout.wave_grows")
        METRICS.gauge("elastic.wave_size", len(self.tracker.workers()))
        FLIGHTREC.dump("mesh_resize", extra={
            "kind": "scaleout_wave", "direction": "grow",
            "old_wave": old, "new_wave": self.n_workers, "worker": wid})
        return wid

    def retire_worker(self, worker_id: str | None = None) -> str | None:
        """Shrink the wave by ONE idle worker — the graceful inverse of
        :meth:`register_worker` (the autoscaler's scale-in seam).

        Only a worker with NO in-flight job is eligible (drain, never
        abandon: a mid-job worker finishes and becomes eligible next
        window), and the last enabled worker is never retired.  The
        target ``n_workers`` drops FIRST so the respawn sweep cannot
        refill the hole, then the worker is disabled — it parks on
        heartbeats and takes no further jobs.  Returns the retired id,
        or ``None`` when nothing is eligible right now (the caller
        retries at its next control window)."""
        with self._dispatch_lock:
            live = [w for w in self.tracker.workers()
                    if self.tracker.is_enabled(w)]
            if len(live) <= 1:
                return None
            if worker_id is None:
                idle = [w for w in reversed(live)
                        if self.tracker.job_for(w) is None]
                worker_id = idle[0] if idle else None
            elif (worker_id not in live
                  or self.tracker.job_for(worker_id) is not None):
                worker_id = None
            if worker_id is None:
                return None
            old = self.n_workers
            self.n_workers = max(1, self.n_workers - 1)
            self.tracker.disable_worker(worker_id)
        METRICS.increment("scaleout.wave_shrinks")
        METRICS.gauge("elastic.wave_size",
                      len([w for w in self.tracker.workers()
                           if self.tracker.is_enabled(w)]))
        FLIGHTREC.dump("mesh_resize", extra={
            "kind": "scaleout_wave", "direction": "shrink",
            "old_wave": old, "new_wave": self.n_workers,
            "worker": worker_id})
        return worker_id

    def _evict_stale(self) -> tuple[list[str], list[Job]]:
        """The master's eviction sweep (subclass seam: the process runner
        keeps a booting worker alive)."""
        return self.tracker.evict_stale(self.eviction_timeout_s)

    def _shutdown_workers(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)

    def _observe_heartbeats(self) -> None:
        """Gauge per-worker heartbeat age (how stale each worker looks to
        the master) — the signal the eviction sweep thresholds on."""
        now = time.time()
        for w in self.tracker.workers():
            METRICS.gauge("scaleout.heartbeat_age_s." + w,
                          round(now - self.tracker.last_heartbeat(w), 3))

    # -- master loop ----------------------------------------------------
    def run(self, max_wall_s: float = 300.0) -> Any:
        with trace.span("scaleout.run", n_workers=self.n_workers):
            return self._run(max_wall_s)

    def _requeue_or_quarantine(self, job: Job, requeue: list[Job]) -> None:
        """One more failed attempt for ``job``: re-route it while it has
        retry budget, quarantine it when it runs out (a poison job must
        not wedge the run)."""
        job.attempts += 1
        if job.attempts >= self.max_job_attempts:
            self.tracker.quarantine(job)
            METRICS.increment("scaleout.jobs_quarantined")
        else:
            requeue.append(job)
            METRICS.increment("scaleout.jobs_requeued")

    def _dispatch(self, requeue: list[Job]) -> bool:
        """Hand idle workers their next job — but never a worker whose
        previous update awaits aggregation (the updates dict is keyed by
        worker: a second result would overwrite the first, silently
        breaking the synchronous superstep average), nor a retired one.
        Returns whether any job went out.

        The pending updates are read after the jobs: a worker posts its
        update before it clears its job, so one seen idle has its update
        in that read.  (The reference reads them first: a worker finishing
        between the two reads was handed its next job on the old model,
        and its second update overwrote the first.)"""
        dispatched = False
        workers = self.tracker.workers()
        idle = [w for w in workers if self.tracker.job_for(w) is None]
        pending_updates = self.tracker.updates()
        for wid in idle:
            if wid in pending_updates:
                continue
            if not self.tracker.is_enabled(wid):
                # a retired worker parks: a job handed to it would
                # never run (the reference hands it one)
                continue
            if requeue:
                job = requeue.pop(0)
            elif self.job_iterator.has_next():
                job = self.job_iterator.next(wid)
            else:
                continue
            job.worker_id = wid
            if not job.trace_id:
                # the scaleout.run span is open on this thread, so
                # dispatched jobs inherit the run's trace identity
                ctx = trace.current_trace_context()
                if ctx is not None:
                    job.trace_id, job.parent_span_id = ctx
            self.tracker.add_job(job)
            self._dispatched_at[wid] = time.time()
            METRICS.increment("scaleout.jobs_dispatched")
            dispatched = True
        return dispatched

    def _run(self, max_wall_s: float) -> Any:
        self.tracker.reset_done()    # a prior run's DONE must not no-op us
        METRICS.increment("scaleout.runs")
        self._spawn_workers()
        METRICS.gauge("elastic.wave_size", self.n_workers)
        deadline = time.time() + max_wall_s
        last_evict = time.time()
        requeue: list[Job] = []  # orphaned/failed jobs awaiting re-dispatch
        completed = False
        try:
            while time.time() < deadline:
                if self.tracker.is_done():
                    completed = True
                    break            # external kill (Kill CLI / finish flag)
                # prompt failure reports: the reporting worker's thread (or
                # process) is gone — drop it now and re-route its job,
                # without waiting out the heartbeat timeout
                for wid, job, _err in self.tracker.take_failed():
                    self.tracker.remove_worker(wid)
                    self._dispatched_at.pop(wid, None)
                    self._requeue_or_quarantine(job, requeue)
                # per-job execution deadline (opt-in): a wedged worker is
                # treated like a dead one — removed and its job re-routed
                if self.job_timeout_s > 0:
                    now = time.time()
                    for wid, t0 in list(self._dispatched_at.items()):
                        if now - t0 <= self.job_timeout_s:
                            continue
                        job = self.tracker.job_for(wid)
                        self._dispatched_at.pop(wid, None)
                        if job is None:
                            continue  # finished right at the deadline
                        self.tracker.remove_worker(wid)
                        METRICS.increment("scaleout.job_timeouts")
                        self._requeue_or_quarantine(job, requeue)
                # eviction sweep (reference: every 60 s; scaled to poll rate);
                # orphaned in-flight jobs are re-routed to live workers
                if time.time() - last_evict > max(1.0, self.eviction_timeout_s / 2):
                    self._observe_heartbeats()
                    evicted, orphans = self._evict_stale()
                    if evicted:
                        METRICS.increment("scaleout.workers_evicted", len(evicted))
                        for wid in evicted:
                            self._dispatched_at.pop(wid, None)
                    for job in orphans:
                        self._requeue_or_quarantine(job, requeue)
                    last_evict = time.time()
                # top the pool back up after deaths/evictions (bounded)
                self._maybe_respawn()
                if self.router.send_work():
                    self.router.update()
                    if self.model_saver is not None:
                        current = self.tracker.get_current()
                        if current is not None:
                            self.model_saver.save(current)
                with self._dispatch_lock:
                    dispatched = self._dispatch(requeue)
                if (not self.job_iterator.has_next()
                        and not requeue
                        and not self.tracker.current_jobs()
                        and not self.tracker.has_failures()
                        and not dispatched):
                    # drain final updates
                    if self.tracker.updates():
                        self.router.update()
                        if self.model_saver is not None:
                            current = self.tracker.get_current()
                            if current is not None:
                                self.model_saver.save(current)
                    self.tracker.finish()
                    completed = True
                    break
                time.sleep(self.poll_s)
        finally:
            self._shutdown_workers()
        if not completed:
            # the old behavior — returning half-finished state on deadline
            # as if nothing happened — was indistinguishable from success
            METRICS.increment("scaleout.run_timeouts")
            if self.on_timeout == "raise":
                raise ScaleoutTimeout(max_wall_s, partial=self.tracker.get_current())
        return self.tracker.get_current()
