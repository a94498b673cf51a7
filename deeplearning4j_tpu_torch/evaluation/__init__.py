"""Evaluation of classifiers (port of ``deeplearning4j_tpu/evaluation``)."""

from .evaluation import ConfusionMatrix, Evaluation

__all__ = ["ConfusionMatrix", "Evaluation"]
