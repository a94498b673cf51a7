"""Quad tree with center-of-mass summaries (Barnes-Hut).

Capability match of ``clustering/quadtree/QuadTree.java:483``: 2-D spatial
subdivision with per-cell center of mass and cumulative size, plus the
Barnes-Hut force accumulation used by t-SNE's repulsive term.

Port of ``deeplearning4j_tpu/clustering/quadtree.py``: host code, copied.
"""

from __future__ import annotations

import numpy as np


MAX_DEPTH = 48  # duplicates/near-duplicates stop subdividing past this


class QuadTree:
    __slots__ = ("center", "half", "com", "size", "children", "point",
                 "index", "depth_")

    def __init__(self, center, half, depth: int = 0):
        self.center = np.asarray(center, np.float64)
        self.half = float(half)
        self.com = np.zeros(2)
        self.size = 0
        self.children: list[QuadTree] | None = None
        self.point = None
        self.index = -1
        self.depth_ = depth

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, points) -> "QuadTree":
        pts = np.asarray(points, np.float64)
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        center = (lo + hi) / 2
        half = float(max((hi - lo).max() / 2 * 1.001, 1e-9))
        tree = cls(center, half)
        for i, p in enumerate(pts):
            tree.insert(p, i)
        return tree

    def contains(self, p) -> bool:
        return bool(np.all(np.abs(p - self.center) <= self.half + 1e-12))

    def insert(self, p, index) -> None:
        p = np.asarray(p, np.float64)
        self.com = (self.com * self.size + p) / (self.size + 1)
        self.size += 1
        if self.size == 1:
            self.point, self.index = p, index
            return
        # duplicate/near-duplicate guard: past MAX_DEPTH the cell only
        # aggregates (com + size), which is all Barnes-Hut needs — without
        # this, two identical points recurse forever
        if self.depth_ >= MAX_DEPTH:
            return
        if self.children is None:
            self._subdivide()
            if self.point is not None:
                self._child_for(self.point).insert(self.point, self.index)
                self.point, self.index = None, -1
        self._child_for(p).insert(p, index)

    def _subdivide(self):
        h = self.half / 2
        cx, cy = self.center
        self.children = [QuadTree((cx + dx * h, cy + dy * h), h, self.depth_ + 1)
                         for dx in (-1, 1) for dy in (-1, 1)]

    def _child_for(self, p) -> "QuadTree":
        i = (2 if p[0] > self.center[0] else 0) + (1 if p[1] > self.center[1] else 0)
        return self.children[i]

    # ------------------------------------------------------------------ BH force
    def compute_non_edge_forces(self, point, theta: float, index: int):
        """Barnes-Hut negative-force accumulation for one query point.
        Returns (force_vec, sum_q) for the t-SNE repulsive term."""
        force = np.zeros(2)
        sum_q = 0.0
        stack = [self]
        while stack:
            node = stack.pop()
            if node.size == 0 or (node.size == 1 and node.index == index):
                continue
            diff = point - node.com
            d2 = float(diff @ diff) + 1e-12
            if node.children is None or (2.0 * node.half / np.sqrt(d2)) < theta:
                mult = node.size if not (node.size == 1 and node.index == index) else 0
                q = 1.0 / (1.0 + d2)
                sum_q += mult * q
                force += mult * q * q * diff
            else:
                stack.extend(node.children)
        return force, sum_q

    def depth(self) -> int:
        if self.children is None:
            return 1
        return 1 + max(c.depth() for c in self.children)
