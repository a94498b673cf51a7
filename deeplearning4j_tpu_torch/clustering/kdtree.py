"""KD-tree for nearest-neighbor queries.

Capability match of ``clustering/kdtree/KDTree.java`` (353 LoC): axis-cycling
median construction, nearest/knn/range queries.  Host-side numpy (tree
search is branchy host work; the device path for bulk neighbor queries is
the dense distance matrix in ``kmeans``/t-SNE).  Port of
``deeplearning4j_tpu/clustering/kdtree.py``, copied.
"""

from __future__ import annotations

import numpy as np


class _Node:
    __slots__ = ("point", "index", "axis", "left", "right")

    def __init__(self, point, index, axis):
        self.point = point
        self.index = index
        self.axis = axis
        self.left = None
        self.right = None


class KDTree:
    def __init__(self, points):
        self.points = np.asarray(points, np.float64)
        self.n, self.d = self.points.shape
        idx = np.arange(self.n)
        self.root = self._build(idx, 0)

    def _build(self, idx, depth):
        if idx.size == 0:
            return None
        axis = depth % self.d
        order = idx[np.argsort(self.points[idx, axis], kind="stable")]
        mid = order.size // 2
        node = _Node(self.points[order[mid]], int(order[mid]), axis)
        node.left = self._build(order[:mid], depth + 1)
        node.right = self._build(order[mid + 1:], depth + 1)
        return node

    def nearest(self, query) -> tuple[int, float]:
        """(index, distance) of the closest stored point."""
        query = np.asarray(query, np.float64)
        best = [(-1, np.inf)]

        def visit(node):
            if node is None:
                return
            dist = float(np.linalg.norm(node.point - query))
            if dist < best[0][1]:
                best[0] = (node.index, dist)
            diff = query[node.axis] - node.point[node.axis]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near)
            if abs(diff) < best[0][1]:
                visit(far)

        visit(self.root)
        return best[0]

    def knn(self, query, k: int) -> list[tuple[int, float]]:
        query = np.asarray(query, np.float64)
        heap: list[tuple[float, int]] = []  # max-heap via negated dist

        import heapq

        def visit(node):
            if node is None:
                return
            dist = float(np.linalg.norm(node.point - query))
            if len(heap) < k:
                heapq.heappush(heap, (-dist, node.index))
            elif dist < -heap[0][0]:
                heapq.heapreplace(heap, (-dist, node.index))
            diff = query[node.axis] - node.point[node.axis]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far)

        visit(self.root)
        return sorted(((i, -nd) for nd, i in heap), key=lambda t: t[1])

    def range_search(self, lower, upper) -> list[int]:
        """Indices of points inside the axis-aligned box [lower, upper]."""
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        out: list[int] = []

        def visit(node):
            if node is None:
                return
            if np.all(node.point >= lower) and np.all(node.point <= upper):
                out.append(node.index)
            if node.point[node.axis] >= lower[node.axis]:
                visit(node.left)
            if node.point[node.axis] <= upper[node.axis]:
                visit(node.right)

        visit(self.root)
        return sorted(out)
