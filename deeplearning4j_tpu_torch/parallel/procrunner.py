"""Multi-PROCESS scaleout runtime: the master/worker loop of
``scaleout.DistributedRunner`` with workers as real OS processes.

This is the cluster-of-JVMs capability of the reference
(``DeepLearning4jDistributed.java:128-187`` — master + worker nodes joined
through Akka, shared state in Hazelcast, updates spilled to local files)
mapped to the single-host-many-process shape: worker subprocesses share a
:class:`~.procstate.FileStateTracker` directory, updates spill to disk
(``LocalFileUpdateSaver`` parity), and a SIGKILL'd worker *process* is
detected by heartbeat staleness, evicted, and its in-flight job re-routed —
the real recovery chain, not a thread simulation.

The performer travels as a ``"module:callable"`` spec string resolved by
import in the worker process — the same reflection pattern the reference
uses for ``WorkerPerformerFactory`` (``MasterActor.java:166-180``).

Port of ``deeplearning4j_tpu/parallel/procrunner.py``.  A worker is
``python -m deeplearning4j_tpu_torch.parallel.worker_main``, with this
package's root first on its ``PYTHONPATH``.  A worker imports torch (a few
seconds of start-up, which the boot barrier waits out) but touches CUDA
only if its performer computes on the card; a result crosses the file
plane as numpy (``FileStateTracker.add_update``).  One change of
behaviour: a worker admitted mid-run (``register_worker``, the elastic
wave's grow) or respawned counts as alive until its boot marker appears
(within its boot deadline), so the eviction sweep does not remove it
while its interpreter is still importing.  The reference waits out a
respawned worker's boot in the master loop but not a registered one's,
which a ``torch`` import longer than the eviction timeout evicts.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any

from ..resilience.faults import FAULTS, WorkerKilled
from .procstate import FileStateTracker
from .scaleout import DistributedRunner, IterativeReduceWorkRouter

#: seconds a spawned worker may take to boot (its interpreter's imports)
_BOOT_TIMEOUT_S = 120.0


def resolve_performer_factory(spec: str):
    """``"pkg.module:attr"`` -> the factory callable."""
    mod, _, attr = spec.partition(":")
    return getattr(importlib.import_module(mod), attr)


def worker_loop(state_dir: str, worker_id: str, performer_spec: str,
                heartbeat_s: float = 0.05, poll_s: float = 0.02) -> None:
    """Worker-process main loop (``WorkerActor.java:150-160`` semantics:
    heartbeat every tick, pull the assigned job, perform, push the update)."""
    tracker = FileStateTracker(state_dir)
    performer = resolve_performer_factory(performer_spec)(tracker)
    # boot marker: interpreter startup can take seconds (site hooks import
    # heavy deps), so the master must not start the eviction clock until
    # the worker is actually alive — it waits for this file
    (tracker.dir / "boot" / worker_id).touch()
    while not tracker.is_done():
        tracker.heartbeat(worker_id)
        if not tracker.is_enabled(worker_id):
            time.sleep(heartbeat_s)
            continue
        if tracker.needs_replicate(worker_id):
            current = tracker.get_current()
            if current is not None:
                performer.update(current)
            tracker.done_replicating(worker_id)
        job = tracker.job_for(worker_id)
        if job is None:
            time.sleep(poll_s)
            continue
        # chaos seams (armed via DL4J_TPU_FAULTS, inherited through the
        # spawn env): silent process death / straggler / transient failure
        FAULTS.maybe_fire("scaleout.worker")
        slow = FAULTS.check("scaleout.worker.slow")
        if slow is not None:
            time.sleep(slow.delay_s)
        try:
            FAULTS.maybe_fire("scaleout.perform")
            performer.perform(job)
        except WorkerKilled:
            raise                # injected silent death: no failure report
        except Exception as e:
            # prompt failure report — the master re-routes the job without
            # waiting out the heartbeat timeout; this process then exits
            tracker.record_failure(worker_id, job, repr(e))
            raise
        if job.result is not None:
            tracker.add_update(worker_id, job.result)
        tracker.clear_job(worker_id)


class ProcessDistributedRunner(DistributedRunner):
    """``DistributedRunner`` with OS-process workers over a shared
    :class:`FileStateTracker` directory.

    ``performer_spec`` replaces the in-process factory: a
    ``"module:callable"`` string importable in the worker interpreter.
    ``worker_env`` is added to each worker's environment (tests pin
    ``OMP_NUM_THREADS=1``).
    """

    def __init__(self, job_iterator, performer_spec: str, state_dir: Path | str,
                 n_workers: int = 2, router_cls=IterativeReduceWorkRouter,
                 heartbeat_s: float = 0.05, poll_s: float = 0.02,
                 eviction_timeout_s: float = 2.0,
                 model_saver=None, worker_env: dict[str, str] | None = None,
                 max_job_attempts: int = 3, job_timeout_s: float = 0.0,
                 max_respawns: int = 0, on_timeout: str = "raise"):
        tracker = FileStateTracker(state_dir)
        super().__init__(job_iterator, performer_factory=None,
                         n_workers=n_workers, router_cls=router_cls,
                         tracker=tracker, model_saver=model_saver,
                         heartbeat_s=heartbeat_s, poll_s=poll_s,
                         eviction_timeout_s=eviction_timeout_s,
                         max_job_attempts=max_job_attempts,
                         job_timeout_s=job_timeout_s,
                         max_respawns=max_respawns, on_timeout=on_timeout)
        self.state_dir = str(state_dir)
        self.performer_spec = performer_spec
        self.worker_env = worker_env
        self._procs: list[subprocess.Popen] = []
        self._spawned_wids: list[str] = []
        self._booting: dict[str, float] = {}   # worker -> boot deadline

    def worker_processes(self) -> list[subprocess.Popen]:
        """Live Popen handles (tests use these to SIGKILL a worker)."""
        return list(self._procs)

    def _spawn_one(self, wid: str) -> None:
        env = dict(os.environ)
        if self.worker_env:
            env.update(self.worker_env)
        # make this package importable in the worker regardless of master
        # cwd, ahead of any other copy on the path
        pkg_root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        self.tracker.add_worker(wid)
        self._booting[wid] = time.time() + _BOOT_TIMEOUT_S
        log = open(Path(self.state_dir) / f"{wid}.log", "wb")
        self._procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel.worker_main",
             self.state_dir, wid, self.performer_spec,
             str(self.heartbeat_s), str(self.poll_s)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
        self._spawned_wids.append(wid)

    def _await_boot(self, wids: list[str], timeout_s: float) -> None:
        """Boot barrier: heartbeats (and thus eviction eligibility) only
        mean something once the worker process is actually up —
        interpreter startup can take seconds (site hooks import heavy
        deps), so the staleness clock restarts when boot completes."""
        deadline = time.time() + timeout_s
        boot = Path(self.state_dir) / "boot"
        while time.time() < deadline:
            if all((boot / w).exists() for w in wids):
                break
            time.sleep(0.05)
        for w in wids:
            self.tracker.heartbeat(w)   # restart staleness clock

    def _evict_stale(self):
        """A worker still booting (no boot marker yet, inside its boot
        deadline) is alive: its heartbeat is refreshed before the sweep."""
        boot = Path(self.state_dir) / "boot"
        now = time.time()
        for wid, deadline in list(self._booting.items()):
            if (boot / wid).exists() or now > deadline:
                self._booting.pop(wid, None)
            else:
                self.tracker.heartbeat(wid)
        return super()._evict_stale()

    def _spawn_workers(self) -> None:
        super()._spawn_workers()        # parallel Popen via _spawn_one
        self._await_boot(list(self._spawned_wids), _BOOT_TIMEOUT_S)

    def _maybe_respawn(self) -> None:
        before = set(self._spawned_wids)
        super()._maybe_respawn()
        new = [w for w in self._spawned_wids if w not in before]
        if new:
            # replacement processes boot serially with the master waiting —
            # bounded (respawn is rare and capped), and without the wait a
            # short eviction timeout would evict the replacement mid-boot
            self._await_boot(new, 30.0)

    def _shutdown_workers(self) -> None:
        self.tracker.finish()          # workers exit their loop on DONE
        deadline = time.time() + 10.0
        for p in self._procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()


def collect_result(state_dir: Path | str) -> Any:
    """The final aggregated model from a finished run's state directory."""
    return FileStateTracker(state_dir).get_current()
