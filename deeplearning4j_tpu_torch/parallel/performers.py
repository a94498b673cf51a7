"""Example ``WorkerPerformer``s + aggregators, importable by spec string in
worker processes (``resolve_performer_factory``).

Port of ``deeplearning4j_tpu/parallel/performers.py``: host code (numpy and
``collections.Counter``), so a worker running one of these never touches
CUDA.  The spec strings are ``deeplearning4j_tpu_torch.parallel.performers:
<Name>``.

- :class:`WordCountPerformer` — the reference's distributed word-count
  "hello world" (``deeplearning4j-scaleout/deeplearning4j-nlp/src/main/java/
  org/deeplearning4j/scaleout/perform/text/`` WordCountWorkPerformer et al.):
  the natural smoke test of the scaleout SPI, counting tokens per job and
  summing counts across workers via :class:`CounterAggregator`.
- :class:`VectorDeltaPerformer` — deterministic parameter-averaging-style
  performer used by the elastic-recovery tests: each job adds a known delta
  to the current model, so the final model equals init + sum(deltas) iff
  every job ran exactly once.
- :class:`SlowVectorDeltaPerformer` — same, with a sleep inside ``perform``
  to widen the SIGKILL window for process-death tests.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np

from .scaleout import IterativeReduceWorkRouter, Job


class CounterAggregator:
    """Sums ``collections.Counter`` results across workers (the word-count
    aggregation; contrast with ``ArrayAggregator``'s running average)."""

    def __init__(self):
        self._total = Counter()

    def accumulate(self, job: Job) -> None:
        if job.result:
            self._total.update(job.result)

    def aggregate(self) -> Counter:
        return Counter(self._total)


class WordCountPerformer:
    """Tokenize-and-count: ``job.work`` is a text line (or token list);
    ``job.result`` is a Counter of token frequencies."""

    def __init__(self, tracker):
        self.tracker = tracker

    def perform(self, job: Job) -> None:
        work = job.work
        tokens = work.split() if isinstance(work, str) else list(work)
        job.result = Counter(tokens)

    def update(self, *args) -> None:
        pass


class WordCountRouter(IterativeReduceWorkRouter):
    """Synchronous router whose aggregate ACCUMULATES across waves (counts
    are a running total, unlike the parameter-averaging ArrayAggregator
    which replaces the current model each superstep)."""

    def __init__(self, tracker):
        super().__init__(tracker, aggregator_factory=CounterAggregator)

    def update(self) -> None:
        updates = self.tracker.updates()
        if not updates:
            return
        agg = CounterAggregator()
        current = self.tracker.get_current()
        if current:
            agg._total.update(current)
        for wid, upd in updates.items():
            agg.accumulate(Job(work=None, worker_id=wid, result=upd))
        self.tracker.set_current(agg.aggregate())
        self.tracker.clear_updates(list(updates))


class VectorDeltaPerformer:
    """current-model + per-job delta (order-free total; see module doc)."""

    dim = 4

    def __init__(self, tracker):
        self.tracker = tracker

    def perform(self, job: Job) -> None:
        current = self.tracker.get_current()
        base = np.zeros(self.dim) if current is None else np.asarray(current)
        job.result = base + np.full(self.dim, float(job.work))

    def update(self, *args) -> None:
        pass


class SlowVectorDeltaPerformer(VectorDeltaPerformer):
    """0.25 s of "work" before the delta — keeps a job in-flight long
    enough for a test to SIGKILL the worker process mid-perform."""

    def perform(self, job: Job) -> None:
        time.sleep(0.25)
        super().perform(job)


class SVMLightTrainPerformer:
    """IterativeReduce worker over svmlight byte-range splits — the YARN
    path's SVMLight worker (``hadoop-yarn/cdh4/.../IRUnitSVMLightWorkerTest``
    pattern: each worker trains on its input split, the master averages).

    ``job.work`` is ``"path::start::end::num_features::num_classes"``;
    ``local_steps`` softmax-regression gradient steps over the split,
    starting from the current averaged model (workers train locally, the
    superstep averages — the IterativeReduce shape), emitting updated flat
    params for the ``ArrayAggregator`` average."""

    lr = 0.5
    local_steps = 10

    def __init__(self, tracker):
        self.tracker = tracker

    def perform(self, job: Job) -> None:
        from ..datasets.svmlight import load_svmlight
        path, s, e, nf, nc = str(job.work).split("::")
        s, e, nf, nc = int(s), int(e), int(nf), int(nc)
        x, y = load_svmlight(path, nf, nc, start=s, end=e)
        cur = self.tracker.get_current()
        w = (np.zeros((nf, nc)) if cur is None
             else np.asarray(cur).reshape(nf, nc))
        for _ in range(self.local_steps):
            logits = x @ w
            logits -= logits.max(-1, keepdims=True)
            p = np.exp(logits)
            p /= p.sum(-1, keepdims=True)
            w = w - self.lr * (x.T @ (p - y)) / max(len(x), 1)
        job.result = w.reshape(-1)

    def update(self, *args) -> None:
        pass
