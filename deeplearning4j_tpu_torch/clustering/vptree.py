"""Vantage-point tree.

Capability match of ``clustering/vptree/VpTreeNode.java:290`` +
``VpTreePointINDArray``: metric-space nearest neighbors (used by Barnes-Hut
t-SNE's input-similarity pass).

Port of ``deeplearning4j_tpu/clustering/vptree.py``: host code, copied.
"""

from __future__ import annotations

import heapq

import numpy as np


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index):
        self.index = index
        self.threshold = 0.0
        self.inside = None
        self.outside = None


class VPTree:
    def __init__(self, points, seed: int = 0):
        self.points = np.asarray(points, np.float64)
        rng = np.random.default_rng(seed)
        self.root = self._build(list(range(self.points.shape[0])), rng)

    def _dist(self, i, q):
        return float(np.linalg.norm(self.points[i] - q))

    def _build(self, idx: list[int], rng):
        if not idx:
            return None
        vp = idx[int(rng.integers(len(idx)))]
        rest = [i for i in idx if i != vp]
        node = _VPNode(vp)
        if not rest:
            return node
        dists = np.linalg.norm(self.points[rest] - self.points[vp], axis=1)
        node.threshold = float(np.median(dists))
        inside = [i for i, d in zip(rest, dists) if d <= node.threshold]
        outside = [i for i, d in zip(rest, dists) if d > node.threshold]
        node.inside = self._build(inside, rng)
        node.outside = self._build(outside, rng)
        return node

    def knn(self, query, k: int) -> list[tuple[int, float]]:
        query = np.asarray(query, np.float64)
        heap: list[tuple[float, int]] = []  # max-heap (negated)
        tau = [np.inf]

        def visit(node):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.index] - query))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d <= node.threshold:
                visit(node.inside)
                if d + tau[0] > node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        return sorted(((i, -nd) for nd, i in heap), key=lambda t: t[1])

    def nearest(self, query) -> tuple[int, float]:
        return self.knn(query, 1)[0]
