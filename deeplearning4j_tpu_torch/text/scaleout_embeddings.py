"""Distributed embedding training over the scaleout SPI — row shipping.

Host-level capability match of the reference's distributed Word2Vec/GloVe
(``scaleout/perform/models/word2vec/Word2VecWork.java``,
``Word2VecPerformer.java:72-137``, ``Word2VecJobIterator.java``, GloVe mirror
``GlovePerformer.java``/``GloveWork.java``):

- the master-side job iterator slices the corpus into sentence chunks and
  ships each worker a ``Word2VecWork`` carrying ONLY the table rows the
  chunk's words (and their Huffman paths / pre-drawn negatives) touch;
- the worker trains those rows with the same batched device steps as the
  local model (``word2vec._hs_step`` / ``_ns_step``, on its ``device``:
  the card unless the CPU is asked for) and returns per-row DELTAS as
  numpy, so only the touched rows cross back to the master;
- the aggregator sums deltas into the master tables, which the next wave of
  works is built from.

Learning-rate decay follows ``Word2VecPerformer.java:82``: linear in the
distributed words-processed counter (StateTracker ``increment``/``count``).

For the SPMD mesh equivalent of the same strategy (tables sharded over the
``ep`` axis, row shipping as psum), see ``text/sharded_embedding.py``.

Port of ``deeplearning4j_tpu/text/scaleout_embeddings.py``.  The master's
tables and the shipped rows are numpy, as the reference's; the job
iterator draws its negatives from the same ``np.random.default_rng(seed)``
stream, so a one-worker run reproduces the reference's from the same
tables.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.scaleout import Job, StateTracker
from .word2vec import _host, _hs_step, _ns_step, skipgram_pairs

WORDS_KEY = "w2v.words_processed"


@dataclasses.dataclass
class EmbeddingTables:
    """Master-side tables + Huffman/pair metadata (the
    ``InMemoryLookupTable`` role)."""

    syn0: np.ndarray                       # (n, d)
    syn1: np.ndarray                       # (n-1, d) HS inner nodes
    codes: np.ndarray                      # (n, L)
    points: np.ndarray                     # (n, L)
    lengths: np.ndarray                    # (n,)
    syn1neg: np.ndarray | None = None      # (n, d) when negative > 0
    unigram: np.ndarray | None = None      # 0.75-power unigram probs

    @classmethod
    def from_model(cls, w2v) -> "EmbeddingTables":
        """Build from a vocab-initialised (unfitted) Word2Vec."""
        if w2v.vocab is None:
            w2v.build_vocab()
        if w2v.syn0 is None:
            w2v.reset_weights()
        codes, points, lengths = w2v.huffman.code_arrays()
        neg = w2v.negative > 0
        unigram = None
        if neg:
            c = w2v.vocab.counts_array() ** 0.75
            unigram = (c / c.sum()).astype(np.float64)
        return cls(
            syn0=_host(w2v.syn0),
            syn1=_host(w2v.syn1),
            codes=codes.astype(np.float32), points=points, lengths=lengths,
            syn1neg=_host(w2v.syn1neg) if neg else None,
            unigram=unigram)


@dataclasses.dataclass
class Word2VecWork:
    """The shipped unit (``Word2VecWork.java``): sentence indices plus the
    exact rows they touch.  ``rows*`` map global row index → vector copy."""

    sentences: list[np.ndarray]
    rows0: dict[int, np.ndarray]
    rows1: dict[int, np.ndarray]
    rows1neg: dict[int, np.ndarray]
    negatives: np.ndarray | None           # (n_pairs_est, k) pre-drawn
    alpha: float


@dataclasses.dataclass
class RowDeltas:
    """Per-row deltas returned by a worker (reference: the updated rows in
    ``Word2VecWork.addDeltas``)."""

    d0: dict[int, np.ndarray]
    d1: dict[int, np.ndarray]
    d1neg: dict[int, np.ndarray]
    n_words: int


class Word2VecJobIterator:
    """Slices the (pre-tokenized) corpus and builds row-shipping works
    (``Word2VecJobIterator.java``)."""

    def __init__(self, sentences_idx: Sequence[np.ndarray],
                 tables: EmbeddingTables, *, window: int = 5,
                 chunk: int = 8, negative: int = 0, hs: bool | None = None,
                 alpha: float = 0.025, min_alpha: float = 1e-2,
                 iterations: int = 1, seed: int = 42,
                 tracker: StateTracker | None = None):
        self.sentences_idx = list(sentences_idx)
        self.tables = tables
        self.window = window
        self.chunk = chunk
        self.negative = negative
        self.hs = hs if hs is not None else negative == 0
        self.alpha = alpha
        self.min_alpha = min_alpha
        self.iterations = iterations
        self.rng = np.random.default_rng(seed)
        self.tracker = tracker
        self.total_words = max(
            1, sum(int(s.size) for s in self.sentences_idx) * iterations)
        self._cursor = 0
        self._epoch = 0

    def _chunks_left(self) -> bool:
        return (self._epoch < self.iterations - 1
                or self._cursor < len(self.sentences_idx))

    def has_next(self) -> bool:
        return self._chunks_left()

    def reset(self) -> None:
        self._cursor = 0
        self._epoch = 0

    def next(self, worker_id: str = "") -> Job:
        if self._cursor >= len(self.sentences_idx):
            self._cursor = 0
            self._epoch += 1
        sents = self.sentences_idx[self._cursor:self._cursor + self.chunk]
        self._cursor += self.chunk

        words = np.unique(np.concatenate(sents)) if sents else np.zeros(0, int)
        t = self.tables
        rows0 = {int(w): t.syn0[w].copy() for w in words}
        rows1: dict[int, np.ndarray] = {}
        if self.hs:
            for w in words:
                for li in range(int(t.lengths[w])):
                    p = int(t.points[w, li])
                    if p not in rows1:
                        rows1[p] = t.syn1[p].copy()
        rows1neg: dict[int, np.ndarray] = {}
        negatives = None
        if self.negative > 0 and t.syn1neg is not None and words.size:
            n_pairs_est = sum(int(s.size) for s in sents) * 2 * self.window
            negatives = self.rng.choice(
                t.unigram.size, size=(max(n_pairs_est, 1), self.negative),
                p=t.unigram).astype(np.int32)
            for p in np.unique(negatives):
                rows1neg[int(p)] = t.syn1neg[p].copy()
            for w in words:
                rows1neg.setdefault(int(w), t.syn1neg[w].copy())

        # linear alpha decay by the DISTRIBUTED words-processed counter
        # (Word2VecPerformer.java:82)
        seen = self.tracker.count(WORDS_KEY) if self.tracker else 0.0
        alpha = max(self.min_alpha,
                    self.alpha * (1.0 - seen / self.total_words))
        work = Word2VecWork(sentences=list(sents), rows0=rows0, rows1=rows1,
                            rows1neg=rows1neg, negatives=negatives,
                            alpha=alpha)
        return Job(work=work, worker_id=worker_id)


class Word2VecPerformer:
    """Worker side (``Word2VecPerformer.java:72-137``): train the shipped
    rows on the chunk's skip-gram pairs with the batched device steps on
    ``device`` (default the card), return per-row deltas as numpy."""

    def __init__(self, tracker: StateTracker, *, window: int = 5,
                 negative: int = 0, codes: np.ndarray | None = None,
                 points: np.ndarray | None = None,
                 lengths: np.ndarray | None = None, seed: int = 7,
                 device=None):
        self.tracker = tracker
        self.window = window
        self.negative = negative
        self.codes, self.points, self.lengths = codes, points, lengths
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def update(self, *args) -> None:  # replication hook (tables ride works)
        pass

    def perform(self, job: Job) -> None:
        work: Word2VecWork = job.work
        centers, contexts = skipgram_pairs(work.sentences, self.window, self.rng)
        n_words = int(sum(s.size for s in work.sentences))
        if centers.size == 0:
            job.result = RowDeltas({}, {}, {}, n_words)
            return

        # local sub-tables from the shipped rows, remapped indices; the
        # rate rounded to float32 once, as the reference rounds it
        alpha = float(np.float32(work.alpha))
        f32, i64 = torch.float32, torch.int64
        idx0 = {w: i for i, w in enumerate(sorted(work.rows0))}
        sub0 = np.stack([work.rows0[w] for w in sorted(work.rows0)])
        c_loc = np.array([idx0[int(c)] for c in centers], np.int32)

        d1, d1neg = {}, {}
        if self.codes is not None and work.rows1:
            keys1 = np.array(sorted(work.rows1), np.int64)
            idx1 = {int(p): i for i, p in enumerate(keys1)}
            sub1 = np.stack([work.rows1[int(p)] for p in keys1])
            L = self.codes.shape[1]
            pts = self.points[contexts]                     # (B, L) global
            lut1 = np.zeros(int(self.points.max()) + 1, np.int32)
            lut1[keys1] = np.arange(keys1.size, dtype=np.int32)
            pts_loc = lut1[pts]                             # masked slots → 0
            cds = self.codes[contexts]
            msk = (np.arange(L)[None, :]
                   < self.lengths[contexts][:, None]).astype(np.float32)
            s0, s1 = _hs_step(self._dev(sub0, f32), self._dev(sub1, f32),
                              self._dev(c_loc, i64), self._dev(pts_loc, i64),
                              self._dev(cds, f32), self._dev(msk, f32), alpha)
            s0, s1 = _host(s0), _host(s1)
            d1 = {p: s1[i] - work.rows1[p] for p, i in idx1.items()}
            sub0 = s0
        if self.negative > 0 and work.rows1neg:
            keysn = np.array(sorted(work.rows1neg), np.int64)
            idxn = {int(p): i for i, p in enumerate(keysn)}
            subn = np.stack([work.rows1neg[int(p)] for p in keysn])
            negs = work.negatives[np.arange(centers.size)
                                  % work.negatives.shape[0]]
            tgt = np.concatenate([contexts[:, None], negs], axis=1)
            lutn = np.zeros(int(keysn.max()) + 1, np.int32)
            lutn[keysn] = np.arange(keysn.size, dtype=np.int32)
            tgt_loc = lutn[tgt]
            labels = np.zeros_like(tgt, np.float32)
            labels[:, 0] = 1.0
            s0, sn = _ns_step(self._dev(sub0, f32), self._dev(subn, f32),
                              self._dev(c_loc, i64), self._dev(tgt_loc, i64),
                              self._dev(labels, f32), alpha)
            s0, sn = _host(s0), _host(sn)
            d1neg = {p: sn[i] - work.rows1neg[p] for p, i in idxn.items()}
            sub0 = s0
        d0 = {w: sub0[i] - work.rows0[w] for w, i in idx0.items()}

        self.tracker.increment(WORDS_KEY, n_words)
        job.result = RowDeltas(d0=d0, d1=d1, d1neg=d1neg, n_words=n_words)


class RowDeltaAggregator:
    """Sums workers' per-row deltas into the master tables (the master-side
    apply in ``Word2VecWork.addDeltas`` / ``MasterActor`` broadcast)."""

    def __init__(self, tables: EmbeddingTables):
        self.tables = tables

    def accumulate(self, job: Job) -> None:
        r: RowDeltas = job.result
        for w, d in r.d0.items():
            self.tables.syn0[w] += d
        for p, d in r.d1.items():
            self.tables.syn1[p] += d
        if self.tables.syn1neg is not None:
            for p, d in r.d1neg.items():
                self.tables.syn1neg[p] += d

    def aggregate(self) -> EmbeddingTables:
        return self.tables
