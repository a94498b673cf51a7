"""Filesystem-backed scaleout state plane — the cross-PROCESS analog of
``scaleout.StateTracker``.

Port of ``deeplearning4j_tpu/parallel/procstate.py``, with its directory
layout (``workers/``, ``heartbeats/``, ``jobs/``, ``updates/``, ``saved/``,
``replicate/``, ``disabled/``, ``counters/``, ``boot/``, ``failed/``,
``quarantined/``, ``current``, ``DONE``).  Updates and the current model
are written through ``scaleout.to_host``: a tensor crosses the plane as a
numpy array, so no reader needs a CUDA context to unpickle it.

Capability parity targets in the reference:

- ``statetracker/updatesaver/LocalFileUpdateSaver.java:20`` — per-worker
  param updates spilled to local files so the data grid stays small and
  updates survive restarts.  Here: :class:`FileUpdateSaver` (and the
  tracker's ``add_update`` routes through it — updates live on disk, never
  in a master-process dict).
- ``statetracker/workretriever/LocalWorkRetriever.java:19`` — per-worker job
  persistence for re-retrieval after a restart: :class:`FileWorkRetriever`.
- ``BaseHazelCastStateTracker.java:31,61-76`` — the shared blackboard
  (workers/heartbeats/jobs/updates/current model) reachable from every
  process.  Hazelcast's role (an in-memory grid shared by JVMs) maps to a
  shared directory of atomically-replaced pickle files: each worker process
  writes only its own files, the master is the only writer of the shared
  model, so no cross-process locking is needed beyond atomic rename.

Used by :class:`~.procrunner.ProcessDistributedRunner`, whose workers are
real OS processes (SIGKILL-able) rather than threads.
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path
from typing import Any, Callable

from .scaleout import to_host

__all__ = ["FileUpdateSaver", "FileWorkRetriever", "FileStateTracker"]


def _atomic_pickle(path: Path, value: Any) -> None:
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        pickle.dump(value, f)
    tmp.replace(path)


def _load_pickle(path: Path, default: Any = None) -> Any:
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (FileNotFoundError, EOFError, pickle.UnpicklingError):
        # mid-replace or already removed — treat as absent
        return default


class FileUpdateSaver:
    """Per-worker update spill (``LocalFileUpdateSaver.java:20``): one
    pickle per worker id, atomically replaced."""

    def __init__(self, directory: Path | str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, worker_id: str, update: Any) -> None:
        _atomic_pickle(self.dir / worker_id, update)

    def load(self, worker_id: str) -> Any:
        return _load_pickle(self.dir / worker_id)

    def ids(self) -> list[str]:
        return sorted(p.name for p in self.dir.iterdir()
                      if ".tmp" not in p.name)

    def clear(self, worker_id: str | None = None) -> None:
        for p in list(self.dir.iterdir()):
            if ".tmp" in p.name:
                continue
            if worker_id is None or p.name == worker_id:
                p.unlink(missing_ok=True)


class FileWorkRetriever:
    """Per-worker job persistence (``LocalWorkRetriever.java:19``): the job
    most recently assigned to a worker, re-retrievable after restart."""

    def __init__(self, directory: Path | str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, worker_id: str, job: Any) -> None:
        _atomic_pickle(self.dir / worker_id, job)

    def load(self, worker_id: str) -> Any:
        return _load_pickle(self.dir / worker_id)


class FileStateTracker:
    """Cross-process StateTracker: same surface as
    ``scaleout.StateTracker``, state under one shared directory.

    Write discipline (lock-free by construction): workers write only
    ``heartbeats/<self>``, ``updates/<self>``, and remove ``jobs/<self>``;
    the master writes ``jobs/*``, ``current``, ``DONE``, and worker
    registration.  Every write is tmp-file + atomic rename.
    """

    def __init__(self, directory: Path | str):
        self.dir = Path(directory)
        for sub in ("workers", "heartbeats", "jobs", "updates", "saved",
                    "replicate", "disabled", "counters", "boot",
                    "failed", "quarantined"):
            (self.dir / sub).mkdir(parents=True, exist_ok=True)
        self.update_saver = FileUpdateSaver(self.dir / "updates")
        self.work_retriever = FileWorkRetriever(self.dir / "saved")
        # master-process-local listeners (parity seam; fires on local adds)
        self.update_listeners: list[Callable[[Any], None]] = []

    # -- workers --------------------------------------------------------
    def add_worker(self, worker_id: str) -> None:
        (self.dir / "workers" / worker_id).touch()
        self.heartbeat(worker_id)

    def remove_worker(self, worker_id: str) -> None:
        for sub in ("workers", "heartbeats", "jobs", "disabled"):
            (self.dir / sub / worker_id).unlink(missing_ok=True)

    def workers(self) -> list[str]:
        return sorted(p.name for p in (self.dir / "workers").iterdir())

    def enable_worker(self, worker_id: str) -> None:
        (self.dir / "disabled" / worker_id).unlink(missing_ok=True)

    def disable_worker(self, worker_id: str) -> None:
        (self.dir / "disabled" / worker_id).touch()

    def is_enabled(self, worker_id: str) -> bool:
        return ((self.dir / "workers" / worker_id).exists()
                and not (self.dir / "disabled" / worker_id).exists())

    # -- heartbeats / failure detection ---------------------------------
    def heartbeat(self, worker_id: str) -> None:
        p = self.dir / "heartbeats" / worker_id
        p.touch()
        os.utime(p)

    def last_heartbeat(self, worker_id: str) -> float:
        try:
            return (self.dir / "heartbeats" / worker_id).stat().st_mtime
        except FileNotFoundError:
            return 0.0

    def evict_stale(self, timeout_s: float = 120.0):
        """(evicted ids, orphaned jobs) — ``MasterActor.java:123-153``."""
        now = time.time()
        evicted, orphans = [], []
        for w in self.workers():
            if now - self.last_heartbeat(w) > timeout_s:
                evicted.append(w)
                job = self.job_for(w)
                if job is not None:
                    orphans.append(job)
                self.remove_worker(w)
        return evicted, orphans

    # -- jobs -----------------------------------------------------------
    def add_job(self, job) -> None:
        _atomic_pickle(self.dir / "jobs" / job.worker_id, job)
        self.work_retriever.save(job.worker_id, job)

    def job_for(self, worker_id: str):
        return _load_pickle(self.dir / "jobs" / worker_id)

    def clear_job(self, worker_id: str) -> None:
        (self.dir / "jobs" / worker_id).unlink(missing_ok=True)

    def current_jobs(self) -> list:
        out = []
        for p in (self.dir / "jobs").iterdir():
            if ".tmp" in p.name:
                continue
            job = _load_pickle(p)
            if job is not None:
                out.append(job)
        return out

    def load_for_worker(self, worker_id: str):
        return self.work_retriever.load(worker_id)

    # -- failures / quarantine ------------------------------------------
    def record_failure(self, worker_id: str, job, error: str = "") -> None:
        """Prompt failure report (``scaleout.StateTracker`` parity).

        Write order matters for the master's finish check: the failed
        record must exist BEFORE the in-flight job file disappears, so
        the master can never observe 'no jobs, no failures' mid-report.
        """
        job.last_error = error
        name = f"{worker_id}.{os.getpid()}.{time.monotonic_ns()}"
        _atomic_pickle(self.dir / "failed" / name, (worker_id, job, error))
        self.clear_job(worker_id)

    def take_failed(self) -> list:
        out = []
        for p in sorted((self.dir / "failed").iterdir()):
            if ".tmp" in p.name:
                continue
            rec = _load_pickle(p)
            if rec is not None:
                out.append(rec)
            p.unlink(missing_ok=True)
        return out

    def has_failures(self) -> bool:
        return any(".tmp" not in p.name
                   for p in (self.dir / "failed").iterdir())

    def quarantine(self, job) -> None:
        name = f"{os.getpid()}.{time.monotonic_ns()}"
        _atomic_pickle(self.dir / "quarantined" / name, job)

    def quarantined(self) -> list:
        out = []
        for p in sorted((self.dir / "quarantined").iterdir()):
            if ".tmp" in p.name:
                continue
            job = _load_pickle(p)
            if job is not None:
                out.append(job)
        return out

    # -- updates (file-backed spill) ------------------------------------
    def add_update(self, worker_id: str, update: Any) -> None:
        update = to_host(update)
        self.update_saver.save(worker_id, update)
        for listener in list(self.update_listeners):
            listener(update)

    def updates(self) -> dict[str, Any]:
        return {w: self.update_saver.load(w) for w in self.update_saver.ids()}

    def clear_updates(self, worker_ids=None) -> None:
        """Drop every pending update, or only ``worker_ids``' (see
        ``scaleout.StateTracker.clear_updates``)."""
        if worker_ids is None:
            self.update_saver.clear()
        for w in worker_ids or ():
            self.update_saver.clear(w)

    # -- counters -------------------------------------------------------
    def increment(self, key: str, by: float = 1.0) -> None:
        # single-writer per key is the expected pattern (master-side);
        # read-modify-write through atomic replace
        self.counter_set(key, self.count(key) + by)

    def counter_set(self, key: str, value: float) -> None:
        _atomic_pickle(self.dir / "counters" / key, float(value))

    def count(self, key: str) -> float:
        return float(_load_pickle(self.dir / "counters" / key, 0.0))

    # -- current model / replication ------------------------------------
    def set_current(self, value: Any) -> None:
        _atomic_pickle(self.dir / "current", to_host(value))
        for w in self.workers():
            (self.dir / "replicate" / w).touch()

    def get_current(self) -> Any:
        return _load_pickle(self.dir / "current")

    def add_replicate(self, worker_id: str) -> None:
        (self.dir / "replicate" / worker_id).touch()

    def needs_replicate(self, worker_id: str) -> bool:
        return (self.dir / "replicate" / worker_id).exists()

    def done_replicating(self, worker_id: str) -> None:
        (self.dir / "replicate" / worker_id).unlink(missing_ok=True)

    # -- lifecycle ------------------------------------------------------
    def finish(self) -> None:
        (self.dir / "DONE").touch()

    def reset_done(self) -> None:
        (self.dir / "DONE").unlink(missing_ok=True)

    def is_done(self) -> bool:
        return (self.dir / "DONE").exists()
