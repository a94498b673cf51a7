"""Word2Vec — skip-gram with hierarchical softmax and negative sampling,
batched on the GPU.

Port of ``deeplearning4j_tpu/text/word2vec.py`` (capability match of the
reference's ``models/word2vec/Word2Vec.java`` +
``InMemoryLookupTable.java:144-279``): vocab build with min-frequency
pruning, Huffman tree, skip-gram windows, hierarchical softmax over the
Huffman path, negative sampling from the 0.75-power unigram table,
subsampling, linear LR decay by pairs processed, similarity /
nearest-neighbour queries, and (de)serialization via ``serializer``.

The host assembles BATCHES of (center, context, padded Huffman path)
index arrays exactly as the JAX package does (same numpy generator, same
native pair generator, same permutation); each batch is one update on
device tensors (:func:`_hs_step`, :func:`_ns_step`): gathers, two
batched products and scatter-adds.  A scatter-add with repeated indices
is ``index_put_(..., accumulate=True)``, which sums in a fixed order on
CUDA (a sort, not atomics), so a fit is reproducible.  The tables are
updated in place.  Negatives are drawn by ``torch.multinomial`` on a
generator seeded from ``seed``: torch cannot reproduce the JAX key's
stream, so the two packages' negative-sampling fits differ in their
draws (a single step on the same targets agrees).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..observability import METRICS, trace
from .tokenization import CommonPreprocessor, DefaultTokenizerFactory
from .vocab import Huffman, VocabCache, build_vocab


# --------------------------------------------------------------------------- steps

def _hs_step(syn0, syn1, centers, points, codes, mask, alpha):
    """Hierarchical-softmax skip-gram update for a batch of pairs, in
    place.

    centers: (B,) int; points/codes/mask: (B, L) Huffman path arrays.
    label = 1 - code (word2vec convention)."""
    h = syn0[centers]                                  # (B, D)
    w = syn1[points]                                   # (B, L, D)
    u = torch.einsum("bd,bld->bl", h, w)
    p = torch.sigmoid(u)
    g = (1.0 - codes - p) * alpha * mask               # (B, L)
    dh = torch.einsum("bl,bld->bd", g, w)
    dw = g[:, :, None] * h[:, None, :]
    syn1.index_put_((points,), dw, accumulate=True)
    syn0.index_put_((centers,), dh, accumulate=True)
    return syn0, syn1


def _ns_step(syn0, syn1neg, centers, targets, labels, alpha):
    """Negative-sampling update, in place.

    centers: (B,); targets: (B, 1+K) (context + K negatives);
    labels: (B, 1+K) 1 for context, 0 for negatives."""
    h = syn0[centers]
    w = syn1neg[targets]                               # (B, 1+K, D)
    u = torch.einsum("bd,bkd->bk", h, w)
    p = torch.sigmoid(u)
    g = (labels - p) * alpha
    dh = torch.einsum("bk,bkd->bd", g, w)
    dw = g[:, :, None] * h[:, None, :]
    syn1neg.index_put_((targets,), dw, accumulate=True)
    syn0.index_put_((centers,), dh, accumulate=True)
    return syn0, syn1neg


def _sample_negatives(gen, probs, shape):
    """``shape`` draws from the unigram distribution ``probs``."""
    n = shape[0] * shape[1]
    return torch.multinomial(probs, n, replacement=True,
                             generator=gen).view(shape)


def _ns_labels(n: int, negative: int, device) -> torch.Tensor:
    """(n, 1+K) labels: 1 for the context column, 0 for the negatives."""
    labels = torch.zeros((n, 1 + negative), dtype=torch.float32,
                         device=device)
    labels[:, 0] = 1.0
    return labels


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a table the next step updates)."""
    return t.detach().to("cpu", copy=True).numpy()


def _path_tables(codes, points, lengths, device):
    """The Huffman tables as device tensors: codes (f32), points (int64)
    and the mask of each path's real length (f32)."""
    L = codes.shape[1]
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    return (torch.as_tensor(codes, dtype=torch.float32, device=device),
            torch.as_tensor(points, dtype=torch.int64, device=device),
            torch.as_tensor(mask, device=device))


# --------------------------------------------------------------------------- pair generation

def skipgram_pairs(sentences_idx: Sequence[np.ndarray], window: int,
                   rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """All (center, context) skip-gram pairs with random window shrink
    (the reference draws a random gap per position, Word2Vec.java:312).
    Native C++ fast path when the host library is built."""
    try:
        from ..native import runtime as native_rt
        native = native_rt.skipgram_pairs(
            list(sentences_idx), window, int(rng.integers(1, 2**63)))
        if native is not None:
            return native
    except ImportError:
        pass
    centers, contexts = [], []
    for idx in sentences_idx:
        n = idx.size
        b = rng.integers(0, window, n)  # random reduced window
        for pos in range(n):
            w = window - b[pos]
            lo, hi = max(0, pos - w), min(n, pos + w + 1)
            for j in range(lo, hi):
                if j != pos:
                    centers.append(idx[pos])
                    contexts.append(idx[j])
    if not centers:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return np.asarray(centers, np.int32), np.asarray(contexts, np.int32)


# --------------------------------------------------------------------------- model

class Word2Vec:
    """Skip-gram embeddings with the reference's knobs; the tables live
    on ``device`` (default CUDA)."""

    def __init__(self, sentences: Iterable[str] | None = None, *,
                 layer_size: int = 100, window: int = 5,
                 min_word_frequency: float = 1.0, iterations: int = 1,
                 learning_rate: float = 0.025, min_learning_rate: float = 1e-2,
                 negative: int = 0, use_hierarchic_softmax: bool = True,
                 sample: float = 0.0, batch_size: int = 4096,
                 seed: int = 42, tokenizer_factory=None, device=None):
        self.sentences = list(sentences) if sentences is not None else []
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.iterations = iterations
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.use_hs = use_hierarchic_softmax or negative == 0
        self.sample = sample
        self.batch_size = batch_size
        self.seed = seed
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory(
            CommonPreprocessor())
        self.device = resolve_device(device)

        self.vocab: VocabCache | None = None
        self.huffman: Huffman | None = None
        self.syn0 = None
        self.syn1 = None
        self.syn1neg = None
        self._codes = self._points = self._lengths = None
        self._unigram = None

    # ------------------------------------------------------------------ setup
    def build_vocab(self) -> None:
        self.vocab = build_vocab(self.sentences, self.tokenizer_factory,
                                 self.min_word_frequency)
        self.huffman = Huffman(self.vocab)
        self.huffman.build()
        self._codes, self._points, self._lengths = self.huffman.code_arrays()

    def reset_weights(self) -> None:
        """syn0 uniform +-0.5/dim, syn1 zeros (InMemoryLookupTable
        ``resetWeights``)."""
        n, d = len(self.vocab), self.layer_size
        rng = np.random.default_rng(self.seed)
        self.syn0 = torch.as_tensor(
            (rng.random((n, d), np.float32) - 0.5) / d, device=self.device)
        self.syn1 = torch.zeros((max(n - 1, 1), d), dtype=torch.float32,
                                device=self.device)
        if self.negative > 0:
            self.syn1neg = torch.zeros((n, d), dtype=torch.float32,
                                       device=self.device)
            counts = self.vocab.counts_array() ** 0.75
            self._unigram = torch.as_tensor(
                counts / counts.sum(), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ data
    def _sentence_indices(self, rng: np.random.Generator) -> list[np.ndarray]:
        """Tokenize sentences to pruned index arrays, with subsampling."""
        out = []
        total = self.vocab.total_word_count
        counts = self.vocab.counts_array() if self.sample > 0 else None
        for s in self.sentences:
            toks = self.tokenizer_factory.create(s).get_tokens()
            idx = [self.vocab.index_of(t) for t in toks]
            idx = np.array([i for i in idx if i >= 0], np.int32)
            if self.sample > 0 and idx.size:
                freqs = counts[idx] / total
                keep_p = np.minimum(1.0, np.sqrt(self.sample / freqs)
                                    + self.sample / freqs)
                idx = idx[rng.random(idx.size) < keep_p]
            if idx.size >= 2:
                out.append(idx)
        return out

    def _pairs(self, sentences_idx: Sequence[np.ndarray],
               rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        return skipgram_pairs(sentences_idx, self.window, rng)

    # ------------------------------------------------------------------ step seams
    # (a sharded Word2Vec overrides these to run the same schedule over
    # sharded tables)
    def _apply_hs(self, cb, pts, cds, msk, alpha):
        self.syn0, self.syn1 = _hs_step(self.syn0, self.syn1, cb, pts, cds,
                                        msk, alpha)

    def _apply_ns(self, cb, targets, labels, alpha):
        self.syn0, self.syn1neg = _ns_step(self.syn0, self.syn1neg, cb,
                                           targets, labels, alpha)

    @property
    def embeddings(self) -> np.ndarray:
        """(n_vocab, D) host array — trims any shard padding."""
        return _host(self.syn0[:len(self.vocab)])

    # ------------------------------------------------------------------ fit
    def fit(self) -> "Word2Vec":
        if self.vocab is None:
            self.build_vocab()
        if self.syn0 is None:
            self.reset_weights()
        dev = self.device
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        codes, points, mask_table = _path_tables(
            self._codes, self._points, self._lengths, dev)

        # Linear alpha decay over total training PAIRS (the reference decays
        # by words seen, Word2VecPerformer.java:82; pairs are the unit our
        # batches process — estimated from the first epoch's pair count so
        # the schedule spans all of training instead of collapsing early).
        pairs_total = None
        pairs_seen = 0.0
        for it in range(self.iterations):
            with trace.span("word2vec.pairs", iteration=it):
                sidx = self._sentence_indices(rng)
                centers, contexts = self._pairs(sidx, rng)
            n_pairs = centers.shape[0]
            if pairs_total is None:
                pairs_total = max(1.0, float(n_pairs) * self.iterations)
            perm = rng.permutation(n_pairs)
            # one host-to-device copy an epoch; batches are device slices
            c_all = torch.as_tensor(centers[perm].astype(np.int64),
                                    device=dev)
            x_all = torch.as_tensor(contexts[perm].astype(np.int64),
                                    device=dev)
            with trace.span("word2vec.epoch", iteration=it,
                            pairs=int(n_pairs)):
                for off in range(0, n_pairs, self.batch_size):
                    cb = c_all[off:off + self.batch_size]
                    xb = x_all[off:off + self.batch_size]
                    alpha = max(
                        self.min_learning_rate,
                        self.learning_rate * (1.0 - pairs_seen / pairs_total))
                    if self.use_hs:
                        self._apply_hs(cb, points[xb], codes[xb],
                                       mask_table[xb], alpha)
                    if self.negative > 0:
                        negs = _sample_negatives(
                            gen, self._unigram, (cb.shape[0], self.negative))
                        targets = torch.cat([xb[:, None], negs], dim=1)
                        labels = _ns_labels(cb.shape[0], self.negative, dev)
                        self._apply_ns(cb, targets, labels, alpha)
                    pairs_seen += cb.shape[0]
                    METRICS.increment("word2vec.batches")
        return self

    # ------------------------------------------------------------------ queries
    def get_word_vector(self, word: str) -> np.ndarray | None:
        i = self.vocab.index_of(word)
        return None if i < 0 else _host(self.syn0[i])

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and word in self.vocab

    def similarity(self, w1: str, w2: str) -> float:
        from .similarity import cosine
        return cosine(self.get_word_vector(w1), self.get_word_vector(w2))

    def words_nearest(self, word_or_vec, n: int = 10) -> list[str]:
        from .similarity import nearest
        if isinstance(word_or_vec, str):
            vec = self.get_word_vector(word_or_vec)
            exclude = {word_or_vec}
            if vec is None:
                return []
        else:
            vec, exclude = np.asarray(word_or_vec), set()
        return nearest(self.embeddings, vec, self.vocab.word_at, n, exclude)

    def accuracy(self, analogies: Sequence[tuple[str, str, str, str]]) -> float:
        """a:b :: c:d analogy accuracy (reference ``accuracy`` API)."""
        good = 0
        for a, b, c, d in analogies:
            va, vb, vc = (self.get_word_vector(w) for w in (a, b, c))
            if va is None or vb is None or vc is None:
                continue
            pred = self.words_nearest(vb - va + vc, n=4)
            if d in pred:
                good += 1
        return good / max(1, len(analogies))
