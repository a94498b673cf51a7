"""L4 — clustering & spatial trees (reference: ``clustering/``).

Port of ``deeplearning4j_tpu/clustering``: k-means sweeps on the device,
the KD, VP and quad trees as host numpy."""

from .kmeans import KMeansClustering
from .kdtree import KDTree
from .vptree import VPTree
from .quadtree import QuadTree

__all__ = ["KMeansClustering", "KDTree", "VPTree", "QuadTree"]
