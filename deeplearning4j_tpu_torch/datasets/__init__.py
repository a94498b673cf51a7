"""Datasets of the port: the ``DataSet`` container and the double-buffered
host-to-device feed (``prefetch_to_device``).  Fetchers and the dataset
iterators come with the capability set (``ROADMAP.md`` A9)."""

from .dataset import DataSet, to_outcome_matrix
from .iterator import prefetch_to_device

__all__ = ["DataSet", "prefetch_to_device", "to_outcome_matrix"]
