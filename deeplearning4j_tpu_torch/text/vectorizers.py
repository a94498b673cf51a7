"""Text vectorizers: bag-of-words and TF-IDF.

Capability match of ``bagofwords/vectorizer/`` in the reference
(``BagOfWordsVectorizer``, ``TfidfVectorizer``): corpus -> (doc x vocab)
matrices, optionally with labels -> DataSet for the classifiers.

Port of ``deeplearning4j_tpu/text/vectorizers.py``: host code, copied as
it is (into the port's ``DataSet``).
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

from ..datasets.dataset import DataSet, to_outcome_matrix
from .tokenization import CommonPreprocessor, DefaultTokenizerFactory
from .vocab import VocabCache, build_vocab


class BagOfWordsVectorizer:
    def __init__(self, min_word_frequency: float = 1.0, tokenizer_factory=None,
                 binary: bool = False):
        self.min_word_frequency = min_word_frequency
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory(
            CommonPreprocessor())
        self.binary = binary
        self.vocab: VocabCache | None = None

    def fit(self, docs: Iterable[str]) -> "BagOfWordsVectorizer":
        self.vocab = build_vocab(docs, self.tokenizer_factory,
                                 self.min_word_frequency)
        return self

    def transform(self, docs: Iterable[str]) -> np.ndarray:
        docs = list(docs)
        out = np.zeros((len(docs), len(self.vocab)), np.float32)
        for r, doc in enumerate(docs):
            for tok in self.tokenizer_factory.create(doc).get_tokens():
                i = self.vocab.index_of(tok)
                if i >= 0:
                    out[r, i] = 1.0 if self.binary else out[r, i] + 1.0
        return out

    def fit_transform(self, docs: Sequence[str]) -> np.ndarray:
        return self.fit(docs).transform(docs)

    def vectorize(self, docs: Sequence[str], labels: Sequence[int],
                  num_classes: int | None = None) -> DataSet:
        x = self.fit_transform(docs)
        labels = np.asarray(labels)
        nc = num_classes or int(labels.max()) + 1
        return DataSet(x, to_outcome_matrix(labels, nc))


class TfidfVectorizer(BagOfWordsVectorizer):
    def __init__(self, **kw):
        super().__init__(**kw)
        self._idf: np.ndarray | None = None

    def fit(self, docs: Iterable[str]) -> "TfidfVectorizer":
        docs = list(docs)
        super().fit(docs)
        df = np.zeros(len(self.vocab), np.float64)
        for doc in docs:
            seen = {self.vocab.index_of(t)
                    for t in self.tokenizer_factory.create(doc).get_tokens()}
            for i in seen:
                if i >= 0:
                    df[i] += 1
        n = len(docs)
        self._idf = np.log((1 + n) / (1 + df)) + 1.0  # smoothed idf
        return self

    def transform(self, docs: Iterable[str]) -> np.ndarray:
        counts = super().transform(docs)
        tf = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1.0)
        return (tf * self._idf).astype(np.float32)
