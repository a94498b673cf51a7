"""Confusion-matrix classification metrics.

Port of ``deeplearning4j_tpu/evaluation/evaluation.py`` (host-side numpy,
copied; the port keeps its own copy): ``ConfusionMatrix`` and
``Evaluation`` with the same formulas and the same ``stats()`` text.
``eval()`` takes one-hot (or probability) matrices, as numpy arrays or
tensors on any device, and argmaxes rows.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Hashable, Iterable

import numpy as np


def _host(x) -> np.ndarray:
    """A numpy array from an array-like or a tensor on any device."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class ConfusionMatrix:
    """Generic actual→(predicted→count) table (``ConfusionMatrix.java:32``)."""

    def __init__(self, classes: Iterable[Hashable] = ()):
        self.matrix: dict[Hashable, Counter] = defaultdict(Counter)
        self.classes: set[Hashable] = set(classes)

    def add(self, actual: Hashable, predicted: Hashable, count: int = 1) -> None:
        self.matrix[actual][predicted] += count
        self.classes.add(actual)
        self.classes.add(predicted)

    def add_all(self, other: "ConfusionMatrix") -> None:
        for a, row in other.matrix.items():
            for p, c in row.items():
                self.add(a, p, c)

    def count(self, actual: Hashable, predicted: Hashable) -> int:
        return self.matrix[actual][predicted]

    def actual_total(self, actual: Hashable) -> int:
        return sum(self.matrix[actual].values())

    def predicted_total(self, predicted: Hashable) -> int:
        return sum(row[predicted] for row in self.matrix.values())

    def total(self) -> int:
        return sum(self.actual_total(a) for a in list(self.matrix))

    def __str__(self) -> str:
        cs = sorted(self.classes)
        lines = ["actual\\pred\t" + "\t".join(map(str, cs))]
        for a in cs:
            lines.append(f"{a}\t" + "\t".join(str(self.count(a, p)) for p in cs))
        return "\n".join(lines)


class Evaluation:
    """Multiclass metrics from argmax'd outcome matrices
    (``Evaluation.java``)."""

    def __init__(self):
        self.confusion = ConfusionMatrix()
        self.true_positives: Counter = Counter()
        self.false_positives: Counter = Counter()
        self.false_negatives: Counter = Counter()

    # ------------------------------------------------------------------ feed
    def eval(self, real_outcomes, guesses) -> None:
        """Rows are examples; argmax of each row is the class
        (``Evaluation.java:33-64``)."""
        real = _host(real_outcomes)
        guess = _host(guesses)
        if real.ndim == 1:
            actual_idx, pred_idx = real.astype(int), guess.astype(int)
        else:
            actual_idx = real.argmax(axis=1)
            pred_idx = guess.argmax(axis=1)
        for a, p in zip(actual_idx.tolist(), pred_idx.tolist()):
            self.confusion.add(a, p)
            if a == p:
                self.true_positives[a] += 1
            else:
                self.false_positives[p] += 1
                self.false_negatives[a] += 1

    def merge(self, other: "Evaluation") -> None:
        self.confusion.add_all(other.confusion)
        self.true_positives.update(other.true_positives)
        self.false_positives.update(other.false_positives)
        self.false_negatives.update(other.false_negatives)

    # ------------------------------------------------------------------ metrics
    def accuracy(self) -> float:
        total = self.confusion.total()
        if total == 0:
            return 0.0
        correct = sum(self.true_positives.values())
        return correct / total

    def precision(self, klass=None) -> float:
        if klass is not None:
            tp, fp = self.true_positives[klass], self.false_positives[klass]
            return tp / (tp + fp) if tp + fp > 0 else 0.0
        cs = sorted(self.confusion.classes)
        return sum(self.precision(c) for c in cs) / len(cs) if cs else 0.0

    def recall(self, klass=None) -> float:
        if klass is not None:
            tp, fn = self.true_positives[klass], self.false_negatives[klass]
            return tp / (tp + fn) if tp + fn > 0 else 0.0
        cs = sorted(self.confusion.classes)
        return sum(self.recall(c) for c in cs) / len(cs) if cs else 0.0

    def f1(self, klass=None) -> float:
        p, r = self.precision(klass), self.recall(klass)
        return 2 * p * r / (p + r) if p + r > 0 else 0.0

    def false_positive_rate(self, klass) -> float:
        fp = self.false_positives[klass]
        tn = self.confusion.total() - (self.true_positives[klass]
                                       + fp + self.false_negatives[klass])
        return fp / (fp + tn) if fp + tn > 0 else 0.0

    def stats(self) -> str:
        """Human-readable report (``Evaluation.java:64``)."""
        lines = ["==========================Scores=========================="]
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        lines.append("===========================================================")
        lines.append(str(self.confusion))
        return "\n".join(lines)
