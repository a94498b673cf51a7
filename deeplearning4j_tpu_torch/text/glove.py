"""GloVe — co-occurrence counting + AdaGrad weighted least squares.

Port of ``deeplearning4j_tpu/text/glove.py`` (capability match of
``models/glove/Glove.java:42`` + ``CoOccurrences.java`` +
``GloveWeightLookupTable.java``): window-weighted co-occurrence counts
on the host (the native counter first), then batched AdaGrad updates of
(w, w~, b, b~) on the device minimizing
f(X_ij) (w_i . w~_j + b_i + b~_j - log X_ij)^2.  Each batch is one
in-place update of the eight tables (:func:`_glove_step`); scatter-adds
with repeated indices are ``index_put_(..., accumulate=True)``
(deterministic on CUDA).  The co-occurrence arrays go to the device once
a fit, and each epoch's permutation (numpy, the JAX package's stream)
once an epoch; batch losses stay on the device and are read in groups of
``resolve_every``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable

import numpy as np
import torch

from ..device import resolve_device
from ..observability import METRICS, trace
from .tokenization import CommonPreprocessor, DefaultTokenizerFactory
from .vocab import VocabCache, build_vocab
from .word2vec import _host


def _glove_step(w, wc, b, bc, hw, hwc, hb, hbc, rows, cols, logx, fx, lr):
    """AdaGrad step on a batch of co-occurrence entries, in place; returns
    the batch loss (a 0-d device tensor).  The update reads the
    accumulators AFTER adding this batch's squared gradients, as the
    reference does."""
    wi, wj = w[rows], wc[cols]
    diff = torch.einsum("bd,bd->b", wi, wj) + b[rows] + bc[cols] - logx
    wdiff = fx * diff                                   # (B,)
    gw = wdiff[:, None] * wj
    gwc = wdiff[:, None] * wi
    gb = wdiff
    # adagrad accumulators
    hw.index_put_((rows,), gw * gw, accumulate=True)
    hwc.index_put_((cols,), gwc * gwc, accumulate=True)
    hb.index_put_((rows,), gb * gb, accumulate=True)
    hbc.index_put_((cols,), gb * gb, accumulate=True)
    w.index_put_((rows,), -lr * gw * torch.rsqrt(hw[rows] + 1e-8),
                 accumulate=True)
    wc.index_put_((cols,), -lr * gwc * torch.rsqrt(hwc[cols] + 1e-8),
                  accumulate=True)
    b.index_put_((rows,), -lr * gb * torch.rsqrt(hb[rows] + 1e-8),
                 accumulate=True)
    bc.index_put_((cols,), -lr * gb * torch.rsqrt(hbc[cols] + 1e-8),
                  accumulate=True)
    return 0.5 * torch.mean(fx * diff * diff)


class CoOccurrences:
    """Window-weighted co-occurrence counts (``CoOccurrences.java``):
    increment by 1/distance within the window."""

    def __init__(self, vocab: VocabCache, tokenizer_factory, window: int = 15):
        self.vocab = vocab
        self.tokenizer_factory = tokenizer_factory
        self.window = window
        self.counts: dict[tuple[int, int], float] = defaultdict(float)
        self._arrays = None          # native-path result (rows, cols, vals)

    def fit(self, sentences: Iterable[str]) -> "CoOccurrences":
        sent_idx = []
        for s in sentences:
            toks = self.tokenizer_factory.create(s).get_tokens()
            idx = [self.vocab.index_of(t) for t in toks]
            sent_idx.append([i for i in idx if i >= 0])
        # native fast path (the GloVe host hot loop, like word2vec's
        # skip-gram generation); exact Python fallback below
        try:
            from ..native import runtime as native_rt
            native = native_rt.cooccurrence(
                [np.asarray(s, np.int32) for s in sent_idx if s], self.window)
        except ImportError:
            native = None
        if native is not None:
            self._arrays = native
            return self
        for idx in sent_idx:
            for pos, wi in enumerate(idx):
                for off in range(1, self.window + 1):
                    j = pos + off
                    if j >= len(idx):
                        break
                    inc = 1.0 / off
                    self.counts[(wi, idx[j])] += inc
                    self.counts[(idx[j], wi)] += inc
        return self

    def arrays(self):
        if getattr(self, "_arrays", None) is not None:
            return self._arrays
        items = list(self.counts.items())
        rows = np.array([ij[0] for ij, _ in items], np.int32)
        cols = np.array([ij[1] for ij, _ in items], np.int32)
        vals = np.array([v for _, v in items], np.float32)
        return rows, cols, vals


class Glove:
    """GloVe model with the reference's knobs (layer size, xMax, alpha,
    learning rate, iterations); the tables live on ``device`` (default
    CUDA)."""

    def __init__(self, sentences: Iterable[str] | None = None, *,
                 layer_size: int = 100, window: int = 15,
                 min_word_frequency: float = 1.0, iterations: int = 5,
                 learning_rate: float = 0.05, x_max: float = 100.0,
                 alpha: float = 0.75, batch_size: int = 8192, seed: int = 42,
                 resolve_every: int = 32, tokenizer_factory=None,
                 device=None):
        self.sentences = list(sentences) if sentences is not None else []
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.iterations = iterations
        self.learning_rate = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.batch_size = batch_size
        self.seed = seed
        self.resolve_every = max(1, resolve_every)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory(
            CommonPreprocessor())
        self.device = resolve_device(device)
        self.vocab: VocabCache | None = None
        self.syn0 = None
        self.losses: list[float] = []

    # ------------------------------------------------------------------ step seams
    # (a sharded GloVe overrides these to run over sharded tables)
    def _init_tables(self, n: int, d: int, rng) -> None:
        dev = self.device

        def uniform():
            return torch.as_tensor(
                (rng.random((n, d), np.float32) - 0.5) / d, device=dev)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        self._tables = [uniform(), uniform(),            # w, wc
                        zeros(n), zeros(n),              # b, bc
                        zeros(n, d), zeros(n, d),        # AdaGrad of w, wc
                        zeros(n), zeros(n)]              # AdaGrad of b, bc

    def _apply_step(self, rows, cols, logx, fx):
        """One AdaGrad batch; returns the DEVICE loss (0-d tensor) so the
        caller decides when to pay the host sync."""
        return _glove_step(*self._tables, rows, cols, logx, fx,
                           self.learning_rate)

    def _final_embeddings(self, n: int):
        w, wc = self._tables[0], self._tables[1]
        return (w + wc)[:n]  # standard GloVe: sum of both embeddings

    def fit(self) -> "Glove":
        with trace.span("glove.cooccurrence"):
            self.vocab = build_vocab(self.sentences, self.tokenizer_factory,
                                     self.min_word_frequency)
            co = CoOccurrences(self.vocab, self.tokenizer_factory,
                               self.window)
            co.fit(self.sentences)
            rows, cols, vals = co.arrays()
        n, d = len(self.vocab), self.layer_size
        rng = np.random.default_rng(self.seed)
        self._init_tables(n, d, rng)
        logx = np.log(np.maximum(vals, 1e-12)).astype(np.float32)
        fx = np.minimum(1.0, (vals / self.x_max) ** self.alpha).astype(np.float32)
        m = rows.shape[0]
        dev = self.device
        rows_d = torch.as_tensor(rows.astype(np.int64), device=dev)
        cols_d = torch.as_tensor(cols.astype(np.int64), device=dev)
        logx_d = torch.as_tensor(logx, device=dev)
        fx_d = torch.as_tensor(fx, device=dev)
        for it in range(self.iterations):
            perm = torch.as_tensor(rng.permutation(m), device=dev)
            epoch_loss = 0.0
            nb = 0
            pending: list = []   # device losses awaiting one batched sync

            def _resolve() -> None:
                # pull then accumulate one batch at a time, in dispatch
                # order: bitwise-identical to per-batch float(loss) sums
                nonlocal epoch_loss
                if pending:
                    for v in torch.stack(pending).tolist():
                        epoch_loss += float(v)
                pending.clear()

            with trace.span("glove.epoch", iteration=it, entries=m):
                for off in range(0, m, self.batch_size):
                    sl = perm[off:off + self.batch_size]
                    pending.append(self._apply_step(
                        rows_d[sl], cols_d[sl], logx_d[sl], fx_d[sl]))
                    nb += 1
                    METRICS.increment("glove.batches")
                    if len(pending) >= self.resolve_every:
                        _resolve()
                _resolve()
            self.losses.append(epoch_loss / max(1, nb))
            METRICS.gauge("glove.epoch_loss", self.losses[-1])
        self.syn0 = self._final_embeddings(n)
        return self

    # query API mirrors Word2Vec
    def get_word_vector(self, word: str):
        i = self.vocab.index_of(word)
        return None if i < 0 else _host(self.syn0[i])

    def similarity(self, w1: str, w2: str) -> float:
        from .similarity import cosine
        return cosine(self.get_word_vector(w1), self.get_word_vector(w2))

    def words_nearest(self, word: str, n: int = 10) -> list[str]:
        from .similarity import nearest
        vec = self.get_word_vector(word)
        if vec is None:
            return []
        return nearest(_host(self.syn0), vec, self.vocab.word_at, n, {word})
