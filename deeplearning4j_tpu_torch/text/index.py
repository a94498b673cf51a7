"""Inverted index with optional on-disk persistence.

Capability match of ``text/invertedindex/InvertedIndex.java:17`` +
``LuceneInvertedIndex.java`` (912 LoC): document ingestion, posting lists,
term/document lookups, batch iteration for embedding training, simple
TF-IDF ranked search, and — like Lucene's on-disk segments — a compact
save/load so a large corpus index survives process restarts, all without
the Lucene dependency (the reference embeds Lucene purely as a corpus
store for Word2Vec batching).

Port of ``deeplearning4j_tpu/text/index.py``: host code, copied.
"""

from __future__ import annotations

import gzip
import json
import math
from collections import defaultdict
from pathlib import Path
from typing import Callable, Iterable, Iterator, Sequence

from .tokenization import CommonPreprocessor, DefaultTokenizerFactory


class InvertedIndex:
    def __init__(self, tokenizer_factory=None):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory(
            CommonPreprocessor())
        self._docs: list[list[str]] = []
        self._labels: list[str | None] = []
        self._postings: dict[str, list[int]] = defaultdict(list)

    # ------------------------------------------------------------------ ingest
    def add_doc(self, text_or_tokens: str | Sequence[str],
                label: str | None = None) -> int:
        tokens = (self.tokenizer_factory.create(text_or_tokens).get_tokens()
                  if isinstance(text_or_tokens, str) else list(text_or_tokens))
        doc_id = len(self._docs)
        self._docs.append(tokens)
        self._labels.append(label)
        for t in set(tokens):
            self._postings[t].append(doc_id)
        return doc_id

    def add_all(self, texts: Iterable[str]) -> None:
        for t in texts:
            self.add_doc(t)

    # ------------------------------------------------------------------ lookup
    def document(self, doc_id: int) -> list[str]:
        return self._docs[doc_id]

    def label(self, doc_id: int) -> str | None:
        return self._labels[doc_id]

    def documents_for(self, word: str) -> list[int]:
        return list(self._postings.get(word, ()))

    def doc_frequency(self, word: str) -> int:
        return len(self._postings.get(word, ()))

    def num_documents(self) -> int:
        return len(self._docs)

    def terms(self) -> list[str]:
        return sorted(self._postings)

    # ------------------------------------------------------------------ iterate
    def batch_iter(self, batch_size: int) -> Iterator[list[list[str]]]:
        """Token-list batches (the reference's Word2Vec minibatch source)."""
        for off in range(0, len(self._docs), batch_size):
            yield self._docs[off:off + batch_size]

    def all_docs(self) -> list[list[str]]:
        return list(self._docs)

    # ------------------------------------------------------------------ persist
    def save(self, path: str | Path) -> None:
        """Persist docs+labels as gzipped JSON lines (the Lucene-directory
        role); postings are rebuilt on load, so the file stays one
        source of truth."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with gzip.open(tmp, "wt", encoding="utf-8") as f:
            for tokens, label in zip(self._docs, self._labels):
                f.write(json.dumps({"t": tokens, "l": label}) + "\n")
        tmp.replace(path)

    @classmethod
    def load(cls, path: str | Path, tokenizer_factory=None) -> "InvertedIndex":
        idx = cls(tokenizer_factory)
        with gzip.open(Path(path), "rt", encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    idx.add_doc(rec["t"], rec.get("l"))
        return idx

    # ------------------------------------------------------------------ search
    def search(self, query: str, n: int = 10) -> list[tuple[int, float]]:
        """TF-IDF ranked (doc_id, score)."""
        q_tokens = self.tokenizer_factory.create(query).get_tokens()
        n_docs = max(1, len(self._docs))
        scores: dict[int, float] = defaultdict(float)
        for t in q_tokens:
            df = self.doc_frequency(t)
            if df == 0:
                continue
            idf = math.log((1 + n_docs) / (1 + df)) + 1.0
            for d in self._postings[t]:
                tf = self._docs[d].count(t) / max(1, len(self._docs[d]))
                scores[d] += tf * idf
        return sorted(scores.items(), key=lambda kv: -kv[1])[:n]
