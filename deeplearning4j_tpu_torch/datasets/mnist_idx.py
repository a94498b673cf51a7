"""IDX binary format reader and writer (MNIST).

Port of ``deeplearning4j_tpu/datasets/mnist_idx.py``: a vectorized numpy
parse of the IDX image and label files, plain or gzipped, and the writers
that produce them.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

IMAGE_MAGIC = 2051
LABEL_MAGIC = 2049


def _open(path: Path):
    path = Path(path)
    return gzip.open(path, "rb") if path.suffix == ".gz" else open(path, "rb")


def read_idx_images(path: Path | str) -> np.ndarray:
    """(n, rows, cols) uint8."""
    with _open(Path(path)) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != IMAGE_MAGIC:
            raise ValueError(f"bad IDX image magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path: Path | str) -> np.ndarray:
    """(n,) uint8."""
    with _open(Path(path)) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != LABEL_MAGIC:
            raise ValueError(f"bad IDX label magic {magic} in {path}")
        data = np.frombuffer(f.read(n), dtype=np.uint8)
    return data


def write_idx_images(path: Path | str, images: np.ndarray) -> None:
    images = np.asarray(images, dtype=np.uint8)
    n, rows, cols = images.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">IIII", IMAGE_MAGIC, n, rows, cols))
        f.write(images.tobytes())


def write_idx_labels(path: Path | str, labels: np.ndarray) -> None:
    labels = np.asarray(labels, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">II", LABEL_MAGIC, labels.shape[0]))
        f.write(labels.tobytes())
