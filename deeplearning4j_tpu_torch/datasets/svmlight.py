"""SVMLight sparse-text record IO.

Capability match of the reference YARN path's record layer
(``deeplearning4j-scaleout/hadoop-yarn/cdh4/.../iterativereduce/runtime/io/``:
``SVMLightRecordFactory.java:44-125`` line->vector parsing,
``SVMLightDataFetcher.java:57-181`` fetch-into-DataSet,
``SVMLightHDFSDataSetIterator.java`` iterator facade,
``TextRecordParser.java`` split-aware line reading) — redesigned for the
TPU input pipeline: lines parse into *dense batched* numpy arrays up front
(the chip wants one contiguous (N, D) device_put, not a per-example vector
object stream), and byte-range splits replace HDFS input splits so a
multi-host loader can shard one file without a name node.

Format, per the reference parser: ``<label> <idx>:<val> ... # comment``
with 1-based feature indices (0-based raises, matching
``SVMLightRecordFactory.java:96-99``), out-of-range indices skipped with a
warning, and non-negative integer labels used directly as class indices
(``SVMLightDataFetcher.java:19-23``).

Port of ``deeplearning4j_tpu/datasets/svmlight.py``: host code, copied as
it is; the native fast path goes through the port's own
``native.runtime``.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np

from .dataset import DataSet, to_outcome_matrix
from .fetchers import BaseDataFetcher
from .iterator import BaseDatasetIterator


class SVMLightVectorNoLabelError(ValueError):
    """A line had no parsable label (``SVMLightVectorNoLabelException.java``)."""


def parse_svmlight_line(line: str, num_features: int,
                        features_out: np.ndarray | None = None
                        ) -> tuple[np.ndarray, float]:
    """One ``label idx:val ...`` line -> (dense feature row, label).

    Mirrors ``SVMLightRecordFactory.parseFromLine`` semantics: strips
    ``#`` comments, 1-based indices (index 0 raises), indices beyond
    ``num_features`` are skipped with a warning rather than an error.
    """
    body = line.split("#", 1)[0].strip()
    if not body:
        raise SVMLightVectorNoLabelError(f"blank record line: {line!r}")
    parts = body.split()
    try:
        label = float(parts[0])
    except ValueError:
        raise SVMLightVectorNoLabelError(f"no leading label in: {line!r}")
    vec = features_out if features_out is not None else np.zeros(
        num_features, np.float32)
    vec[:] = 0.0
    for tok in parts[1:]:
        idx_s, _, val_s = tok.partition(":")
        index = int(idx_s) - 1          # svmlight text format is 1-based
        if index < 0:
            raise ValueError(
                "SVMLight does not support 0-based indexing in its text "
                f"vector formats: {tok!r}")
        if index < num_features:
            vec[index] = float(val_s)
        else:
            warnings.warn(f"svmlight feature index {index + 1} beyond "
                          f"num_features={num_features}; skipped")
    return vec, label


def load_svmlight(path: str | Path, num_features: int, num_classes: int,
                  start: int = 0, end: int | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Whole file (or a byte-range split of it) -> dense ``(N, D)``
    features + ``(N, C)`` one-hot labels.

    ``start``/``end`` are byte offsets delimiting a split; like the
    reference's ``TextRecordParser``/``HDFSLineParser`` split contract, a
    split that begins mid-line skips forward to the next line boundary and
    the split containing a line's start owns the whole line — so disjoint
    byte ranges over one file partition its records exactly.
    """
    # seek-based split read: only this split's bytes are ever in memory,
    # so N hosts sharing one large file each do O(split) IO, not O(file)
    size = Path(path).stat().st_size
    if end is None:
        end = size
    raw = []
    with open(path, "rb") as f:
        if start > 0:
            f.seek(start - 1)
            f.readline()     # discard through the break; a line that starts
            #                  before `start` belongs to the previous split
        while f.tell() < end:
            line = f.readline()
            if not line:     # a line STARTING before `end` is owned whole,
                break        # even when it extends past the cut
            raw.append(line)
    data = b"".join(raw)

    try:                     # native C fast path (host_runtime.cpp)
        from ..native import runtime as native_rt
        parsed = native_rt.parse_svmlight(data, num_features)
    except ImportError:
        parsed = None
    if parsed is not None:
        feats, labs, skipped = parsed
        if skipped:
            warnings.warn(f"{skipped} svmlight feature indices beyond "
                          f"num_features={num_features}; skipped")
    else:                    # Python parser: exact reference error semantics
        lines = [l for l in data.decode("utf-8").splitlines()
                 if l.split("#", 1)[0].strip()]
        feats = np.zeros((len(lines), num_features), np.float32)
        labs = np.zeros(len(lines), np.float32)
        for i, line in enumerate(lines):
            _, labs[i] = parse_svmlight_line(line, num_features,
                                             features_out=feats[i])
    invalid = ~np.isfinite(labs) | (labs < 0) | (labs != np.floor(labs))
    if np.any(invalid):
        bad = labs[invalid][0]
        raise ValueError(
            f"only non-negative integer class labels are supported "
            f"(got {bad!r}); see SVMLightDataFetcher.java:19-23")
    return feats, to_outcome_matrix(labs.astype(np.int64), num_classes)


def save_svmlight(path: str | Path, features: np.ndarray,
                  labels: np.ndarray) -> None:
    """Write ``(N, D)`` features + labels (one-hot ``(N, C)`` or class-index
    ``(N,)``) as svmlight text — the reference only parses the format; the
    writer closes the round trip for export and for test fixtures."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    classes = labels.argmax(-1) if labels.ndim == 2 else labels.astype(np.int64)
    with open(path, "w") as f:
        for row, c in zip(features, classes):
            nz = np.flatnonzero(row)
            pairs = " ".join(f"{j + 1}:{row[j]:g}" for j in nz)
            f.write(f"{int(c)}{' ' if pairs else ''}{pairs}\n")


class SVMLightDataFetcher(BaseDataFetcher):
    """Cursor/batch fetcher over an svmlight file or byte-range split of
    one (``SVMLightDataFetcher.java:57-181``).  Loads the split once into
    dense arrays; ``fetch(num)`` slices — the per-record Text shuttling of
    the HDFS original has no place in a device-feed path."""

    def __init__(self, path: str | Path, num_features: int, num_classes: int,
                 start: int = 0, end: int | None = None):
        super().__init__()
        self.path, self._nf, self._nc = Path(path), num_features, num_classes
        self._span = (start, end)

    def _load(self):
        return load_svmlight(self.path, self._nf, self._nc, *self._span)


class SVMLightDataSetIterator(BaseDatasetIterator):
    """Batched DataSet iterator over an svmlight file
    (``SVMLightHDFSDataSetIterator.java``)."""

    def __init__(self, path: str | Path, batch: int, num_features: int,
                 num_classes: int, start: int = 0, end: int | None = None,
                 num_examples: int = 0):
        super().__init__(batch, num_examples, SVMLightDataFetcher(
            path, num_features, num_classes, start, end))
