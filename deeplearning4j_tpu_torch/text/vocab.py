"""Vocabulary store + Huffman coding.

Capability match of the reference's ``models/word2vec/wordstore`` package:
``VocabWord`` (word + count + Huffman code/points,
``models/word2vec/VocabWord.java``), ``VocabCache``/``InMemoryLookupCache``
(word<->index maps, counts), vocab building with min-word-frequency pruning
(the actor-based ``VocabActor`` pipeline becomes a single host pass — the
C++ native tokenizer/counter accelerates it when built), and ``Huffman``
(``models/word2vec/Huffman.java:11`` — binary tree over counts assigning
code/point paths used by hierarchical softmax).

Port of ``deeplearning4j_tpu/text/vocab.py``: host code, copied as it is
(the native count goes through the port's own ``native.runtime``).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np


@dataclass
class VocabWord:
    word: str
    count: float = 0.0
    index: int = -1
    codes: list[int] = field(default_factory=list)    # Huffman code bits
    points: list[int] = field(default_factory=list)   # inner-node indices


class VocabCache:
    """word <-> index <-> VocabWord store (``VocabCache.java:15``)."""

    def __init__(self):
        self._words: dict[str, VocabWord] = {}
        self._by_index: list[VocabWord] = []
        self.total_word_count = 0.0

    def add(self, word: str, by: float = 1.0) -> VocabWord:
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word=word)
            self._words[word] = vw
        vw.count += by
        self.total_word_count += by
        return vw

    def finalize_indices(self) -> None:
        """Assign indices by descending count (word2vec convention)."""
        self._by_index = sorted(self._words.values(), key=lambda w: -w.count)
        for i, vw in enumerate(self._by_index):
            vw.index = i

    def prune(self, min_word_frequency: float) -> None:
        kept = {w: vw for w, vw in self._words.items()
                if vw.count >= min_word_frequency}
        removed = sum(vw.count for w, vw in self._words.items() if w not in kept)
        self._words = kept
        self.total_word_count -= removed
        self.finalize_indices()

    # -- lookups ---------------------------------------------------------
    def __contains__(self, word: str) -> bool:
        return word in self._words

    def __len__(self) -> int:
        return len(self._words)

    def word_for(self, word: str) -> VocabWord | None:
        return self._words.get(word)

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_at(self, index: int) -> str:
        return self._by_index[index].word

    def words(self) -> list[str]:
        return [vw.word for vw in self._by_index]

    def count_of(self, word: str) -> float:
        vw = self._words.get(word)
        return vw.count if vw else 0.0

    def counts_array(self) -> np.ndarray:
        return np.array([vw.count for vw in self._by_index], dtype=np.float64)


def build_vocab(sentences: Iterable[str], tokenizer_factory, min_word_frequency: float = 1.0,
                use_native: bool = True) -> VocabCache:
    """One-pass vocab build (replaces the reference's VocabActor pipeline)."""
    # materialize once: the native attempt may consume and then reject the
    # corpus (e.g. non-ASCII), and the fallback must see the same sentences
    sentences = list(sentences)
    cache = VocabCache()
    if use_native:
        try:
            from ..native import runtime as native_rt
            counts = native_rt.count_tokens(sentences, tokenizer_factory)
            if counts is not None:
                for w, c in counts.items():
                    cache.add(w, c)
                cache.prune(min_word_frequency)
                return cache
        except ImportError:
            pass
    for sentence in sentences:
        for tok in tokenizer_factory.create(sentence).get_tokens():
            cache.add(tok)
    cache.prune(min_word_frequency)
    return cache


class Huffman:
    """Huffman tree over vocab counts (``Huffman.java:11``): assigns each
    word its code (bit path) and points (inner-node ids along the path),
    consumed by hierarchical softmax."""

    def __init__(self, cache: VocabCache):
        self.cache = cache
        self.max_code_length = 0

    def build(self) -> None:
        words = [self.cache.word_for(w) for w in self.cache.words()]
        n = len(words)
        if n == 0:
            return
        if n == 1:
            words[0].codes, words[0].points = [0], [0]
            self.max_code_length = 1
            return
        # heap of (count, uid, node); leaves are 0..n-1, inner nodes n..2n-2
        heap: list[tuple[float, int]] = [(w.count, i) for i, w in enumerate(words)]
        heapq.heapify(heap)
        parent = {}
        bit = {}
        next_id = n
        while len(heap) > 1:
            c1, a = heapq.heappop(heap)
            c2, b = heapq.heappop(heap)
            parent[a], bit[a] = next_id, 0
            parent[b], bit[b] = next_id, 1
            heapq.heappush(heap, (c1 + c2, next_id))
            next_id += 1
        root = heap[0][1]
        for i, vw in enumerate(words):
            codes, points = [], []
            node = i
            while node != root:
                codes.append(bit[node])
                points.append(parent[node] - n)  # inner-node index (0-based)
                node = parent[node]
            codes.reverse()
            points.reverse()
            vw.codes, vw.points = codes, points
            self.max_code_length = max(self.max_code_length, len(codes))

    def code_arrays(self, pad_to: int | None = None):
        """(codes, points, lengths) int arrays padded to max code length —
        the batched device-side layout for hierarchical softmax."""
        n = len(self.cache)
        L = pad_to or self.max_code_length
        codes = np.zeros((n, L), np.int32)
        points = np.zeros((n, L), np.int32)
        lengths = np.zeros((n,), np.int32)
        for w in self.cache.words():
            vw = self.cache.word_for(w)
            l = min(len(vw.codes), L)
            codes[vw.index, :l] = vw.codes[:l]
            points[vw.index, :l] = vw.points[:l]
            lengths[vw.index] = l
        return codes, points, lengths
