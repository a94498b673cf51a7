"""ParagraphVectors (PV-DBOW).

Port of ``deeplearning4j_tpu/text/paragraph_vectors.py`` (capability
match of ``models/paragraphvectors/ParagraphVectors.java:38,173``):
document/label vectors trained to predict the words of their documents
(distributed bag of words), sharing the word-side machinery (Huffman HS
or negative sampling) and the in-place device steps with Word2Vec.  The
doc-vector init and the pair permutation are numpy draws, the JAX
package's; negatives come from a generator seeded ``seed + 1`` (17 for
inference).  Inference for unseen documents trains a fresh doc vector
against a copy of the frozen word side.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from .word2vec import (Word2Vec, _host, _hs_step, _ns_labels, _ns_step,
                       _path_tables, _sample_negatives)


class ParagraphVectors(Word2Vec):
    """PV-DBOW on top of the Word2Vec substrate: 'centers' are doc ids into
    a separate doc-vector table."""

    def __init__(self, sentences: Iterable[str], labels: Sequence[str] | None = None,
                 **kw):
        super().__init__(sentences, **kw)
        self.labels = (list(labels) if labels is not None
                       else [f"DOC_{i}" for i in range(len(self.sentences))])
        assert len(self.labels) == len(self.sentences)
        self.doc_vectors = None
        self._label_index = {l: i for i, l in enumerate(self.labels)}

    def fit(self) -> "ParagraphVectors":
        # 1) word vectors via plain skip-gram
        super().fit()
        # 2) doc vectors via PV-DBOW against the (frozen-structure) softmax
        dev = self.device
        rng = np.random.default_rng(self.seed + 1)
        gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        n_docs, d = len(self.sentences), self.layer_size
        self.doc_vectors = torch.as_tensor(
            (rng.random((n_docs, d), np.float32) - 0.5) / d, device=dev)
        codes, points, mask_table = _path_tables(
            self._codes, self._points, self._lengths, dev)

        doc_ids, word_ids = [], []
        for di, s in enumerate(self.sentences):
            toks = self.tokenizer_factory.create(s).get_tokens()
            idx = [self.vocab.index_of(t) for t in toks]
            idx = [i for i in idx if i >= 0]
            for wi in idx:
                doc_ids.append(di)
                word_ids.append(wi)
        doc_ids = torch.as_tensor(np.asarray(doc_ids, np.int64), device=dev)
        word_ids = torch.as_tensor(np.asarray(word_ids, np.int64), device=dev)
        alpha = self.learning_rate
        for it in range(max(1, self.iterations)):
            perm = torch.as_tensor(rng.permutation(doc_ids.shape[0]),
                                   device=dev)
            for off in range(0, doc_ids.shape[0], self.batch_size):
                sl = perm[off:off + self.batch_size]
                db = doc_ids[sl]
                wb = word_ids[sl]
                if self.use_hs:
                    self.doc_vectors, self.syn1 = _hs_step(
                        self.doc_vectors, self.syn1, db,
                        points[wb], codes[wb], mask_table[wb], alpha)
                if self.negative > 0:
                    negs = _sample_negatives(
                        gen, self._unigram, (db.shape[0], self.negative))
                    targets = torch.cat([wb[:, None], negs], dim=1)
                    labels = _ns_labels(db.shape[0], self.negative, dev)
                    self.doc_vectors, self.syn1neg = _ns_step(
                        self.doc_vectors, self.syn1neg, db, targets, labels,
                        alpha)
        return self

    # ------------------------------------------------------------------ queries
    def get_doc_vector(self, label: str) -> np.ndarray | None:
        i = self._label_index.get(label)
        return None if i is None else _host(self.doc_vectors[i])

    def doc_similarity(self, l1: str, l2: str) -> float:
        from .similarity import cosine
        return cosine(self.get_doc_vector(l1), self.get_doc_vector(l2))

    def docs_nearest(self, label: str, n: int = 10) -> list[str]:
        from .similarity import nearest
        vec = self.get_doc_vector(label)
        if vec is None:
            return []
        return nearest(_host(self.doc_vectors), vec, self.labels, n, {label})

    def infer_vector(self, text: str, steps: int = 50,
                     alpha: float = 0.025) -> np.ndarray:
        """Train a fresh doc vector for unseen text (words frozen)."""
        dev = self.device
        toks = self.tokenizer_factory.create(text).get_tokens()
        idx = np.asarray([self.vocab.index_of(t) for t in toks
                          if self.vocab.index_of(t) >= 0], np.int64)
        rng = np.random.default_rng(0)
        dv = torch.as_tensor((rng.random((1, self.layer_size), np.float32)
                              - 0.5) / self.layer_size, device=dev)
        if idx.size == 0:
            return _host(dv[0])
        db = torch.zeros((idx.size,), dtype=torch.int64, device=dev)
        wb = torch.as_tensor(idx, device=dev)
        if self.use_hs:
            codes, points, mask_table = _path_tables(
                self._codes, self._points, self._lengths, dev)
            # a local COPY: the steps update their tables in place
            syn1 = self.syn1.clone()
            for _ in range(steps):
                dv, syn1 = _hs_step(dv, syn1, db, points[wb], codes[wb],
                                    mask_table[wb], alpha)
        else:
            # NS-only model: the HS tree is untrained zeros — infer against
            # the trained syn1neg with fresh negatives per step
            gen = torch.Generator(device=dev).manual_seed(17)
            syn1neg = self.syn1neg.clone()
            labels = _ns_labels(idx.size, self.negative, dev)
            for _ in range(steps):
                negs = _sample_negatives(gen, self._unigram,
                                         (idx.size, self.negative))
                targets = torch.cat([wb[:, None], negs], dim=1)
                dv, syn1neg = _ns_step(dv, syn1neg, db, targets, labels,
                                       alpha)
        return _host(dv[0])
