"""String grid / fingerprint clustering / dedup utilities.

Capability match of the reference's data-cleaning trio:
``util/StringGrid.java`` (a grid of string cells with column ops and
cluster-based dedup), ``util/StringCluster.java`` (groups strings whose
*fingerprint* matches — "Two words", "TWO words", "WORDS TWO" cluster
together), ``util/FingerPrintKeyer.java`` (the OpenRefine-style fingerprint:
case-fold, strip punctuation/accents, unique-sort tokens).

Port of ``deeplearning4j_tpu/utils/stringgrid.py``: host code, copied.
"""

from __future__ import annotations

import re
import unicodedata
from collections import Counter
from pathlib import Path
from typing import Iterable, Sequence

__all__ = ["fingerprint", "ngram_fingerprint", "StringCluster", "StringGrid"]

_PUNCT = re.compile(r"[^\w\s]", re.UNICODE)


def _ascii_fold(s: str) -> str:
    return (unicodedata.normalize("NFKD", s)
            .encode("ascii", "ignore").decode("ascii"))


def fingerprint(s: str) -> str:
    """``FingerPrintKeyer.key``: trim, case-fold, strip punctuation and
    accents, then join the UNIQUE tokens in sorted order."""
    s = _ascii_fold(s.strip().lower())
    s = _PUNCT.sub("", s)
    return " ".join(sorted(set(s.split())))


def ngram_fingerprint(s: str, n: int = 2) -> str:
    """``FingerPrintKeyer`` n-gram variant: unique sorted character n-grams
    of the de-punctuated, de-spaced string."""
    s = _PUNCT.sub("", _ascii_fold(s.strip().lower())).replace(" ", "")
    grams = {s[i:i + n] for i in range(max(0, len(s) - n + 1))}
    return "".join(sorted(grams))


class StringCluster(dict):
    """``StringCluster.java``: fingerprint -> {variant: count}."""

    def __init__(self, strings: Iterable[str]):
        super().__init__()
        for s in strings:
            self.setdefault(fingerprint(s), Counter())[s] += 1

    def clusters(self) -> list[Counter]:
        """Clusters sorted by distinct-variant count desc, then total
        occurrences desc (``SizeComparator``)."""
        return sorted(self.values(),
                      key=lambda m: (-len(m), -sum(m.values())))


class StringGrid(list):
    """``StringGrid.java``: a list of string rows with column operations and
    fingerprint-cluster dedup.  Rows are lists of cells, right-padded with
    ``NONE`` to equal width."""

    NONE = "NONE"

    def __init__(self, sep: str = ",", rows: Iterable[Sequence[str]] = ()):
        super().__init__([list(r) for r in rows])
        self.sep = sep
        self._fill_out()

    # -- construction ---------------------------------------------------
    @classmethod
    def from_lines(cls, lines: Iterable[str], sep: str = ",") -> "StringGrid":
        rows = [cls._split_quoted(ln, sep) for ln in lines if ln.strip()]
        return cls(sep, rows)

    @classmethod
    def from_file(cls, path: str | Path, sep: str = ",") -> "StringGrid":
        return cls.from_lines(Path(path).read_text().splitlines(), sep)

    @staticmethod
    def _split_quoted(line: str, sep: str) -> list[str]:
        """Split on ``sep`` honoring double-quoting and backslash escapes
        (``StringUtils.splitOnCharWithQuoting`` behavior)."""
        out, cur, in_q, esc = [], [], False, False
        for ch in line:
            if esc:
                cur.append(ch)
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_q = not in_q
            elif ch == sep and not in_q:
                out.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        out.append("".join(cur))
        return out

    def _fill_out(self) -> None:
        width = self.num_columns()
        for row in self:
            row.extend([self.NONE] * (width - len(row)))

    # -- shape / access -------------------------------------------------
    def num_columns(self) -> int:
        return max((len(r) for r in self), default=0)

    def get_column(self, column: int) -> list[str]:
        return [row[column] for row in self]

    def head(self, num: int) -> "StringGrid":
        return StringGrid(self.sep, self[:num])

    # -- filtering ------------------------------------------------------
    def remove_rows_with_empty_column(self, column: int,
                                      missing_value: str = "") -> None:
        self[:] = [r for r in self if r[column] != missing_value]

    def remove_columns(self, *columns: int) -> None:
        drop = set(c % self.num_columns() for c in columns)
        self[:] = [[c for j, c in enumerate(r) if j not in drop] for r in self]

    def rows_with_column_values(self, values: Iterable[str],
                                column: int) -> list[list[str]]:
        vals = set(values)
        return [r for r in self if r[column] in vals]

    def filter_rows_by_column(self, column: int,
                              values: Iterable[str]) -> list[int]:
        vals = set(values)
        return [i for i, r in enumerate(self) if r[column] in vals]

    # -- clustering / dedup --------------------------------------------
    def cluster_column(self, column: int) -> StringCluster:
        return StringCluster(self.get_column(column))

    def dedupe_by_cluster(self, column: int) -> None:
        """Canonicalize each cluster of near-duplicate cell values to its
        most frequent variant (``dedupeByCluster``)."""
        cluster = self.cluster_column(column)
        canonical = {}
        for variants in cluster.values():
            best = variants.most_common(1)[0][0]
            for v in variants:
                canonical[v] = best
        for row in self:
            row[column] = canonical.get(row[column], row[column])

    def dedupe_by_cluster_all(self) -> None:
        for c in range(self.num_columns()):
            self.dedupe_by_cluster(c)

    def unique_rows(self) -> "StringGrid":
        seen, out = set(), []
        for r in self:
            key = tuple(r)
            if key not in seen:
                seen.add(key)
                out.append(r)
        return StringGrid(self.sep, out)

    # -- likelihood sort (sortColumnsByWordLikelihoodIncluded) -----------
    def sort_by_word_likelihood(self, column: int) -> None:
        """Sort rows by the mean corpus frequency of the words in the given
        column (most-typical rows first), the reference's word-likelihood
        column sort."""
        counts = Counter()
        for cell in self.get_column(column):
            counts.update(cell.lower().split())
        total = sum(counts.values()) or 1

        def score(row):
            words = row[column].lower().split()
            if not words:
                return 0.0
            return sum(counts[w] / total for w in words) / len(words)

        self.sort(key=score, reverse=True)

    # -- output ---------------------------------------------------------
    def to_lines(self) -> list[str]:
        return [self.sep.join(r) for r in self]

    def write_file(self, path: str | Path) -> None:
        Path(path).write_text("\n".join(self.to_lines()) + "\n")
