"""The disaggregated serving front end.

Port of ``deeplearning4j_tpu/serving/disagg/scheduler.py``.
:class:`DisaggScheduler` owns the pipeline: requests enter a bounded
prefill-tier queue, worker threads prefill them on prefill-role engines,
the :class:`~.migrate.KVMigrator` moves the pages into the decode engine,
and the decode engine's continuous batch takes it from there.  The
scheduler has an engine's surface (``generate``/``submit``/``stats``/
``reload``/``start``/``stop``), so an
:class:`~..router.replicas.EngineReplica` can wrap one.

Failure contract: a killed prefill worker (chaos site
``disagg.prefill_worker``) or a transient migration fault
(``disagg.migrate``) REQUEUES the request at the head of its tier, never
fails it and never corrupts decode state, and the worker respawns.
Requeues are capped; the cap running out is the only path from chaos to
a caller-visible error.  TTFT of a disaggregated request counts from the
scheduler's queue (it stamps ``submitted_s`` once), so ``disagg.ttft``
compares with a unified engine's ``serving.ttft``.
"""

from __future__ import annotations

import threading
import time

from ...observability import METRICS
from ...resilience.faults import FAULTS, TransientStepFault, WorkerKilled
from ..batcher import GenerateRequest, PendingResult, RequestQueue
from ..engine import MigrationRejected
from .migrate import KVMigrator

__all__ = ["DisaggScheduler"]


class DisaggScheduler:
    """Drive requests through prefill engines into one decode engine.

    ``prefill_engines`` must be paged, prefill-role (or at least
    serve-thread-less) engines sharing the decode engine's model
    weights and page geometry; ``decode_engine`` is a normal paged
    engine whose serve loop admits migrations between segments.
    """

    def __init__(self, prefill_engines, decode_engine, *,
                 max_queue: int = 256, max_batch_delay_ms: float = 2.0,
                 workers_per_engine: int = 1,
                 migrate_timeout_s: float = 30.0, max_requeues: int = 3):
        if not prefill_engines:
            raise ValueError("need at least one prefill engine")
        self.prefill_engines = list(prefill_engines)
        self.decode = decode_engine
        self.migrator = KVMigrator(decode_engine)
        self.workers_per_engine = int(workers_per_engine)
        self.migrate_timeout_s = float(migrate_timeout_s)
        self.max_requeues = int(max_requeues)
        self._queue = RequestQueue(
            max_queue, max_batch_delay_ms,
            depth_gauge="serving.queue.depth.prefill")
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []   # guarded-by: self._lock
        self._requeue_counts: dict[int, int] = {}    # guarded-by: self._lock

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "DisaggScheduler":
        self._stop_evt.clear()
        for eng in self.prefill_engines:
            if not eng.stats()["warmed"]:
                eng.start()
        if not self.decode.stats()["running"]:
            self.decode.start()
        with self._lock:
            have = len([t for t in self._threads if t.is_alive()])
        want = len(self.prefill_engines) * self.workers_per_engine
        for i in range(have, want):
            self._spawn(self.prefill_engines[i % len(self.prefill_engines)])
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        self._queue.wake()
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=10.0)
        for p in self._queue.drain():
            p._fail(MigrationRejected("disagg scheduler stopped"))
        for eng in self.prefill_engines:
            eng.stop()
        self.decode.stop()

    def _spawn(self, eng) -> None:
        t = threading.Thread(target=self._worker, args=(eng,),
                             daemon=True, name="disagg-prefill-worker")
        with self._lock:
            self._threads.append(t)
        t.start()

    # ------------------------------------------------------------ submission
    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               seed: int = 0, eos_id: int | None = None,
               deadline_ms: float | None = None, tenant: str = "",
               priority: int = 0) -> PendingResult:
        """Validate + enqueue into the prefill tier; mirrors
        :meth:`InferenceEngine.submit`'s error contract (400 / 429)."""
        cfg = self.decode.model.cfg
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(not 0 <= t < cfg.vocab_size for t in prompt):
            raise ValueError(
                f"prompt token out of range [0, {cfg.vocab_size})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > cfg.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len ({cfg.max_len})")
        req = GenerateRequest(
            prompt=prompt, max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), seed=int(seed), eos_id=eos_id,
            deadline_s=(time.monotonic() + deadline_ms / 1e3
                        if deadline_ms is not None else None),
            priority=int(priority))
        return self._queue.submit(req)

    def generate(self, prompt, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: int | None = None,
                 deadline_ms: float | None = None, tenant: str = "",
                 priority: int = 0, timeout: float | None = None):
        p = self.submit(prompt, max_new_tokens, temperature=temperature,
                        seed=seed, eos_id=eos_id, deadline_ms=deadline_ms,
                        tenant=tenant, priority=priority)
        completion = p.result(timeout)
        if completion.ttft_s is not None:
            METRICS.observe_time("disagg.ttft", completion.ttft_s)
        return completion

    # ------------------------------------------------------------ workers
    def _worker(self, eng) -> None:
        while not self._stop_evt.is_set():
            got = self._queue.take(1, block_s=0.2)
            if not got:
                continue
            p = got[0]
            if not self._queue.claim(p):
                continue   # expired between take and claim — 504 already
            rec = None
            try:
                FAULTS.maybe_fire("disagg.prefill_worker")
                req = p.request
                rec = eng.prefill(req.prompt, req.max_new_tokens,
                                  temperature=req.temperature,
                                  seed=req.seed, eos_id=req.eos_id)
                # kill point with a live prefill record: the handler
                # below must release it — the chaos leg asserts the
                # prefill pool returns to its pre-request refcounts
                FAULTS.maybe_fire("disagg.prefill_worker")
                ticket, _plan = self.migrator.migrate(eng, rec, p)
                rec = None          # consumed by the migrator
                if ticket.wait(self.migrate_timeout_s):
                    with self._lock:
                        self._requeue_counts.pop(p.request.id, None)
                elif not p.done():
                    # admission rejected (weight generation moved):
                    # nothing leaked, nothing decoded — go again
                    self._requeue(p, ticket.reason or "admission rejected")
            except WorkerKilled as e:
                if rec is not None:
                    eng.release_prefill(rec)
                self._requeue(p, str(e))
                self._respawn(eng)
                return              # this worker is dead; a twin took over
            except (TransientStepFault, MigrationRejected, TimeoutError) as e:
                if rec is not None:
                    eng.release_prefill(rec)
                self._requeue(p, str(e))
            except BaseException as e:
                if rec is not None:
                    eng.release_prefill(rec)
                p._fail(e)

    def _respawn(self, eng) -> None:
        if not self._stop_evt.is_set():
            self._spawn(eng)

    def _requeue(self, p: PendingResult, reason: str) -> None:
        """Head-of-tier requeue with a cap — the ONLY way chaos reaches
        the caller is this cap exhausting."""
        if p.done():
            return
        with self._lock:
            n = self._requeue_counts.get(p.request.id, 0) + 1
            self._requeue_counts[p.request.id] = n
        METRICS.increment("disagg.requeues")
        if n > self.max_requeues:
            with self._lock:
                self._requeue_counts.pop(p.request.id, None)
            p._fail(MigrationRejected(
                f"gave up after {n - 1} requeues: {reason}"))
            return
        self._queue.unclaim(p)

    # ------------------------------------------------------------ surface
    def stats(self) -> dict:
        out = dict(self.decode.stats())
        prefill = [e.stats() for e in self.prefill_engines]
        out["role"] = "disagg"
        out["warmed"] = bool(out.get("warmed")) and all(
            s["warmed"] for s in prefill)
        out["prefill_engines"] = len(prefill)
        out["prefill_queue_depth"] = self._queue.depth()
        return out

    def reload(self, step: int):
        """Stage the checkpoint on BOTH tiers — prefill engines apply
        at their next prefill entry, the decode engine at its next
        all-slots-free fence; the migration generation check rejects
        any request whose pages straddle the swap."""
        out = self.decode.reload(step)
        for eng in self.prefill_engines:
            eng.reload(step)
        return out
