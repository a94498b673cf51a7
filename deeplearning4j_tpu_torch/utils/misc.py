"""Host utility grab-bag.

Capability match of the reference's ``util/`` survivors that matter beyond
the JVM: ``MathUtils.java`` statistics/distances/entropy, ``SummaryStatistics``,
``DiskBasedQueue.java:22`` (file-backed FIFO for OOM-safe corpora),
``MovingWindowMatrix``, ``SerializationUtils``, ``ArchiveUtils``.

Port of ``deeplearning4j_tpu/utils/misc.py``: host code, copied.
"""

from __future__ import annotations

import math
import pickle
import shutil
import tarfile
import tempfile
import uuid
import zipfile
from collections import deque
from pathlib import Path
from typing import Any, Iterable

import numpy as np


# --------------------------------------------------------------------------- math (MathUtils.java)

def entropy(probs) -> float:
    p = np.asarray(probs, np.float64)
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


def information_gain(parent_counts, split_counts) -> float:
    parent = np.asarray(parent_counts, np.float64)
    h_parent = entropy(parent / parent.sum())
    total = parent.sum()
    h_children = 0.0
    for counts in split_counts:
        c = np.asarray(counts, np.float64)
        if c.sum() > 0:
            h_children += (c.sum() / total) * entropy(c / c.sum())
    return h_parent - h_children


def euclidean_distance(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


def manhattan_distance(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).sum())


def correlation(x, y) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.std() == 0 or y.std() == 0:
        return 0.0
    return float(np.corrcoef(x, y)[0, 1])


def sigmoid(x) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def bernoulli_log_likelihood(labels, probs) -> float:
    y = np.asarray(labels, np.float64)
    p = np.clip(np.asarray(probs, np.float64), 1e-12, 1 - 1e-12)
    return float((y * np.log(p) + (1 - y) * np.log(1 - p)).sum())


def normalize_to_range(x, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    x = np.asarray(x, np.float64)
    xmin, xmax = x.min(), x.max()
    if xmax == xmin:
        return np.full_like(x, lo)
    return lo + (x - xmin) / (xmax - xmin) * (hi - lo)


class SummaryStatistics:
    """Streaming mean/min/max/std (``SummaryStatistics``-style)."""

    def __init__(self):
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def add(self, value: float) -> None:
        self.n += 1
        delta = value - self._mean
        self._mean += delta / self.n
        self._m2 += delta * (value - self._mean)
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def add_all(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(v)

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def variance(self) -> float:
        return self._m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(self.variance)

    def __str__(self) -> str:
        return (f"n={self.n} mean={self.mean:.6g} std={self.std:.6g} "
                f"min={self.min:.6g} max={self.max:.6g}")


# --------------------------------------------------------------------------- disk queue

class DiskBasedQueue:
    """File-backed FIFO (``DiskBasedQueue.java:22``): keeps an in-memory
    window, spills the rest to per-item pickle files — OOM-safe corpus
    buffering."""

    def __init__(self, directory: str | Path | None = None,
                 memory_window: int = 1000):
        self.dir = Path(directory) if directory else Path(tempfile.mkdtemp(
            prefix="dl4jtpu_queue_"))
        self.dir.mkdir(parents=True, exist_ok=True)
        self.memory_window = memory_window
        self._mem: deque = deque()
        self._spilled: deque[Path] = deque()

    def add(self, item: Any) -> None:
        if len(self._mem) < self.memory_window and not self._spilled:
            self._mem.append(item)
            return
        path = self.dir / f"{uuid.uuid4().hex}.pkl"
        with open(path, "wb") as f:
            pickle.dump(item, f)
        self._spilled.append(path)

    def poll(self) -> Any:
        if self._mem:
            item = self._mem.popleft()
        elif self._spilled:
            path = self._spilled.popleft()
            with open(path, "rb") as f:
                item = pickle.load(f)
            path.unlink(missing_ok=True)
        else:
            raise IndexError("queue empty")
        # refill memory window from disk
        while self._spilled and len(self._mem) < self.memory_window - 1:
            p = self._spilled.popleft()
            with open(p, "rb") as f:
                self._mem.append(pickle.load(f))
            p.unlink(missing_ok=True)
        return item

    def __len__(self) -> int:
        return len(self._mem) + len(self._spilled)

    def is_empty(self) -> bool:
        return len(self) == 0

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


# --------------------------------------------------------------------------- windows

def moving_window_matrix(matrix, window_rows: int, window_cols: int,
                         add_rotations: bool = False) -> np.ndarray:
    """Non-overlapping (rows, cols) windows of a 2-D matrix, flattened per
    window (``MovingWindowMatrix``); optional 90-degree rotations."""
    m = np.asarray(matrix)
    wins = []
    for r in range(0, m.shape[0] - window_rows + 1, window_rows):
        for c in range(0, m.shape[1] - window_cols + 1, window_cols):
            w = m[r:r + window_rows, c:c + window_cols]
            wins.append(w.reshape(-1))
            if add_rotations:
                for k in (1, 2, 3):
                    wins.append(np.rot90(w, k).reshape(-1))
    return np.stack(wins) if wins else np.zeros((0, window_rows * window_cols))


# --------------------------------------------------------------------------- serde / archives

def save_object(obj: Any, path: str | Path) -> None:
    """``SerializationUtils.saveObject`` (pickle, atomic)."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    tmp.replace(path)


def read_object(path: str | Path) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def unzip_file_to(archive: str | Path, dest: str | Path) -> None:
    """``ArchiveUtils`` — tar/tar.gz/zip extraction."""
    archive, dest = Path(archive), Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    name = archive.name
    if name.endswith(".zip"):
        with zipfile.ZipFile(archive) as z:
            z.extractall(dest)
    elif name.endswith((".tar.gz", ".tgz", ".tar")):
        mode = "r:gz" if name.endswith(("gz", "tgz")) else "r"
        with tarfile.open(archive, mode) as t:
            t.extractall(dest, filter="data")  # block tar-slip traversal
    else:
        raise ValueError(f"unknown archive format: {name}")
