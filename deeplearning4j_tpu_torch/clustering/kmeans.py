"""K-means clustering.

Port of ``deeplearning4j_tpu/clustering/kmeans.py`` (capability match of
``clustering/KMeansClustering.java:29,55-111``): k centroids by Lloyd's
algorithm.  A sweep runs on the device over the full ``(n, d)`` matrix:
the distance matrix ``|p|^2 - 2 p.c^T + |c|^2``, its argmin, a one-hot
product for the cluster sums, the old centroid kept for an empty
cluster, and the inertia.  The products run in full float32
(:func:`~..ops.linalg.exact_f32_matmul`): in TF32 the cancellation in
``|p|^2 - 2 p.c`` would move points between clusters.  The host reads
the inertia once a sweep, the convergence test, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..observability import METRICS, trace
from ..ops.linalg import exact_f32_matmul


def _lloyd_step(points, centroids, k):
    with exact_f32_matmul():
        d2 = ((points ** 2).sum(dim=1, keepdim=True)
              - 2.0 * points @ centroids.T
              + (centroids ** 2).sum(dim=1)[None, :])
        assign = d2.argmin(dim=1)
        one_hot = (assign[:, None] == torch.arange(
            k, device=points.device)).to(points.dtype)
        counts = one_hot.sum(dim=0)
        sums = one_hot.T @ points
    new_centroids = torch.where(counts[:, None] > 0,
                                sums / counts[:, None].clamp(min=1.0),
                                centroids)
    inertia = d2.min(dim=1).values.sum()
    return new_centroids, assign, inertia


class KMeansClustering:
    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-6,
                 seed: int = 0, *, device=None):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids: np.ndarray | None = None
        self.inertia: float = float("inf")

    def fit(self, points) -> "KMeansClustering":
        pts = torch.as_tensor(np.asarray(points, np.float32),
                              device=self.device)
        rng = np.random.default_rng(self.seed)
        init_idx = rng.choice(pts.shape[0], self.k, replace=False)
        centroids = pts[torch.as_tensor(init_idx, device=self.device)]
        prev = float("inf")
        with trace.span("kmeans.fit", k=self.k, n=int(pts.shape[0])):
            for _ in range(self.max_iterations):
                centroids, _, inertia = _lloyd_step(pts, centroids, self.k)
                # the relative-tolerance early exit needs the host scalar
                # every sweep: the sync is the convergence test
                cur = float(inertia)
                METRICS.increment("kmeans.sweeps")
                if abs(prev - cur) < self.tol * max(1.0, abs(prev)):
                    break
                prev = cur
        # final assignment/inertia against the FINAL centroids (the loop's
        # values lag one update behind), so labels() agrees with predict()
        _, assign, inertia = _lloyd_step(pts, centroids, self.k)
        self.centroids = centroids.cpu().numpy()
        self.inertia = float(inertia)
        self._assign = assign.cpu().numpy()
        return self

    def predict(self, points) -> np.ndarray:
        pts = np.asarray(points, np.float32)
        d2 = ((pts[:, None, :] - self.centroids[None]) ** 2).sum(-1)
        return d2.argmin(axis=1)

    def labels(self) -> np.ndarray:
        return self._assign
