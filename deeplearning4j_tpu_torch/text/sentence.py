"""Sentence / document iteration SPI.

Capability match of ``text/sentenceiterator`` + ``text/documentiterator`` in
the reference: ``SentenceIterator`` (next/hasNext/reset + preprocessor),
collection/file/line-based implementations, and the label-aware variants
used by ParagraphVectors.

Port of ``deeplearning4j_tpu/text/sentence.py``: host code, copied as it
is.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Iterator, Protocol

SentencePreProcessor = Callable[[str], str]


class SentenceIterator(Protocol):
    def next_sentence(self) -> str: ...
    def has_next(self) -> bool: ...
    def reset(self) -> None: ...


class _Base:
    pre_processor: SentencePreProcessor | None = None

    def _prep(self, s: str) -> str:
        return self.pre_processor(s) if self.pre_processor else s

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(_Base):
    """``CollectionSentenceIterator`` — iterate an in-memory collection."""

    def __init__(self, sentences: Iterable[str]):
        self.sentences = list(sentences)
        self._i = 0

    def next_sentence(self) -> str:
        s = self.sentences[self._i]
        self._i += 1
        return self._prep(s)

    def has_next(self) -> bool:
        return self._i < len(self.sentences)

    def reset(self) -> None:
        self._i = 0


class LineSentenceIterator(CollectionSentenceIterator):
    """``LineSentenceIterator`` — one sentence per line of a file."""

    def __init__(self, path: str | Path):
        lines = [l for l in Path(path).read_text().splitlines() if l.strip()]
        super().__init__(lines)


class FileSentenceIterator(CollectionSentenceIterator):
    """``FileSentenceIterator`` — every file under a directory, one sentence
    per line."""

    def __init__(self, root: str | Path):
        root = Path(root)
        files = sorted(p for p in root.rglob("*") if p.is_file()) if root.is_dir() else [root]
        lines: list[str] = []
        for f in files:
            lines.extend(l for l in f.read_text(errors="ignore").splitlines() if l.strip())
        super().__init__(lines)


class LabelAwareListSentenceIterator(_Base):
    """``text/sentenceiterator/labelaware`` — sentences with labels (for
    ParagraphVectors / supervised windowing)."""

    def __init__(self, sentences: Iterable[str], labels: Iterable[str]):
        self.sentences = list(sentences)
        self.labels = list(labels)
        assert len(self.sentences) == len(self.labels)
        self._i = 0

    def next_sentence(self) -> str:
        s = self.sentences[self._i]
        self._i += 1
        return self._prep(s)

    def current_label(self) -> str:
        return self.labels[self._i - 1 if self._i > 0 else 0]

    def has_next(self) -> bool:
        return self._i < len(self.sentences)

    def reset(self) -> None:
        self._i = 0
