"""Record readers — the raw-record ingestion bridge.

Capability match of the reference's Canova bridge
(``datasets/canova/RecordReaderDataSetIterator.java:23,49-142`` wrapping the
external Canova ``RecordReader``): a RecordReader SPI producing per-example
value lists, concrete CSV / in-memory / file-per-example / image readers, and
the bridge iterator that converts records to DataSets (label column -> one
hot).

Port of ``deeplearning4j_tpu/datasets/records.py``: host code, copied as
it is.  ``ImageRecordReader`` imports PIL when it is built, never at
import.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Protocol, Sequence

import numpy as np

from .dataset import DataSet, to_outcome_matrix
from .iterator import ListDataSetIterator


class RecordReader(Protocol):
    def next_record(self) -> list: ...
    def has_next(self) -> bool: ...
    def reset(self) -> None: ...


class CollectionRecordReader:
    """Records from an in-memory collection of value lists."""

    def __init__(self, records: Sequence[Sequence]):
        self.records = [list(r) for r in records]
        self._i = 0

    def next_record(self) -> list:
        r = self.records[self._i]
        self._i += 1
        return r

    def has_next(self) -> bool:
        return self._i < len(self.records)

    def reset(self) -> None:
        self._i = 0


class CSVRecordReader(CollectionRecordReader):
    """CSV lines -> typed records (numbers parsed, strings kept)."""

    def __init__(self, path: str | Path, skip_lines: int = 0, delimiter: str = ","):
        lines = Path(path).read_text().strip().splitlines()[skip_lines:]
        records = []
        for line in lines:
            if not line.strip():
                continue
            rec = []
            for v in line.split(delimiter):
                v = v.strip()
                try:
                    rec.append(float(v))
                except ValueError:
                    rec.append(v)
            records.append(rec)
        super().__init__(records)


class LineRecordReader(CollectionRecordReader):
    """One record per line (whole line as a single value)."""

    def __init__(self, path: str | Path):
        super().__init__([[l] for l in Path(path).read_text().splitlines() if l])


class ImageRecordReader(CollectionRecordReader):
    """Image files under a directory; label = parent directory name
    (the reference's Canova image reader convention)."""

    def __init__(self, root: str | Path, size: tuple[int, int] = (28, 28)):
        from PIL import Image
        root = Path(root)
        records = []
        for p in sorted(root.rglob("*")):
            if p.suffix.lower() not in (".png", ".jpg", ".jpeg", ".bmp"):
                continue
            img = Image.open(p).convert("L").resize(size)
            arr = np.asarray(img, np.float32).reshape(-1) / 255.0
            records.append(arr.tolist() + [p.parent.name])
        super().__init__(records)


class RecordReaderDataSetIterator(ListDataSetIterator):
    """records -> DataSet batches (``RecordReaderDataSetIterator.java``):
    ``label_index`` column becomes a one-hot target (string labels are
    vocabulary-mapped); -1 = unsupervised (features only, labels=features)."""

    def __init__(self, reader: RecordReader, batch: int = 10,
                 label_index: int = -1, num_classes: int | None = None):
        reader.reset()
        rows = []
        while reader.has_next():
            rows.append(reader.next_record())
        if label_index is None or (label_index == -1 and not num_classes):
            feats = np.asarray(rows, np.float32)
            ds = DataSet(feats, feats)
        else:
            li = label_index % len(rows[0])
            raw = [r[li] for r in rows]
            feats = np.asarray(
                [[float(v) for j, v in enumerate(r) if j != li] for r in rows],
                np.float32)
            try:
                idx = np.asarray([int(float(v)) for v in raw])
            except (TypeError, ValueError):
                vocab = {v: i for i, v in enumerate(sorted({str(v) for v in raw}))}
                idx = np.asarray([vocab[str(v)] for v in raw])
            nc = num_classes or int(idx.max()) + 1
            ds = DataSet(feats, to_outcome_matrix(idx, nc))
        super().__init__(ds, batch)
