"""The DataSet container: features + labels with pipeline helpers.

Port of ``deeplearning4j_tpu/datasets/dataset.py`` (a host-side numpy
container; device placement happens at the train step's boundary).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


def to_outcome_matrix(labels: Sequence[int], num_classes: int) -> np.ndarray:
    """``FeatureUtil.toOutcomeMatrix`` — int labels to one-hot rows."""
    labels = np.asarray(labels, dtype=np.int64)
    out = np.zeros((labels.shape[0], num_classes), dtype=np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


@dataclasses.dataclass
class DataSet:
    """Features (n, ...) + one-hot labels (n, c)."""

    features: np.ndarray
    labels: np.ndarray

    def __post_init__(self):
        self.features = np.asarray(self.features, dtype=np.float32)
        self.labels = np.asarray(self.labels, dtype=np.float32)

    # ------------------------------------------------------------------ basics
    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def __len__(self) -> int:
        return self.num_examples()

    def num_inputs(self) -> int:
        return int(np.prod(self.features.shape[1:]))

    def num_outcomes(self) -> int:
        return int(self.labels.shape[-1])

    def get(self, i) -> "DataSet":
        idx = np.atleast_1d(i)
        return DataSet(self.features[idx], self.labels[idx])

    def copy(self) -> "DataSet":
        return DataSet(self.features.copy(), self.labels.copy())

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(np.concatenate([d.features for d in datasets]),
                       np.concatenate([d.labels for d in datasets]))

    # ------------------------------------------------------------------ pipeline
    def shuffle(self, seed: int | None = None) -> "DataSet":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_examples())
        return DataSet(self.features[perm], self.labels[perm])

    def split_test_and_train(self, num_train: int) -> tuple["DataSet", "DataSet"]:
        """``SplitTestAndTrain`` — first n as train, rest as test."""
        return (DataSet(self.features[:num_train], self.labels[:num_train]),
                DataSet(self.features[num_train:], self.labels[num_train:]))

    def normalize_zero_mean_unit_variance(self) -> "DataSet":
        mean = self.features.mean(axis=0, keepdims=True)
        std = self.features.std(axis=0, keepdims=True)
        std[std == 0] = 1.0
        return DataSet((self.features - mean) / std, self.labels)

    def scale_minmax(self, lo: float = 0.0, hi: float = 1.0) -> "DataSet":
        fmin = self.features.min(axis=0, keepdims=True)
        fmax = self.features.max(axis=0, keepdims=True)
        rng = np.where(fmax - fmin == 0, 1.0, fmax - fmin)
        return DataSet(lo + (self.features - fmin) / rng * (hi - lo), self.labels)

    def binarize(self, threshold: float = 0.5) -> "DataSet":
        return DataSet((self.features > threshold).astype(np.float32), self.labels)

    def round_to_zero_one(self) -> "DataSet":
        return self.binarize(0.5)

    def sample(self, num: int, seed: int | None = None,
               with_replacement: bool = True) -> "DataSet":
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.num_examples(), size=num, replace=with_replacement)
        return DataSet(self.features[idx], self.labels[idx])

    def filter_by_outcome(self, outcomes: Sequence[int]) -> "DataSet":
        mask = np.isin(self.labels.argmax(axis=1), np.asarray(outcomes))
        return DataSet(self.features[mask], self.labels[mask])

    def sort_by_outcome(self) -> "DataSet":
        order = np.argsort(self.labels.argmax(axis=1), kind="stable")
        return DataSet(self.features[order], self.labels[order])

    def batch_by(self, batch_size: int) -> list["DataSet"]:
        n = self.num_examples()
        return [DataSet(self.features[i:i + batch_size], self.labels[i:i + batch_size])
                for i in range(0, n, batch_size)]

    def iterate_batches(self, batch_size: int) -> Iterator["DataSet"]:
        yield from self.batch_by(batch_size)

    def as_reconstruction(self) -> "DataSet":
        """labels := features (unsupervised view)."""
        return DataSet(self.features, self.features.reshape(self.num_examples(), -1))

    def outcome_counts(self) -> np.ndarray:
        return self.labels.sum(axis=0)
