"""t-SNE: exact (dense device math) and Barnes-Hut variants.

Port of ``deeplearning4j_tpu/plot/tsne.py`` (capability match of
``plot/Tsne.java:42``, exact t-SNE with the adaptive-perplexity binary
search ``hBeta``/``computeGaussianPerplexity`` at ``:143,164,261-428``,
and ``plot/BarnesHutTsne.java:36``, the theta-approximated gradient with
the quad tree).  The exact variant's ``(n, n)`` distance matrix, its
gradient and KL run on the device as dense torch math, the products in
full float32 (:func:`~..ops.linalg.exact_f32_matmul`; TF32's rounding
of ``|y_i|^2 - 2 y_i.y_j + |y_j|^2`` would swamp near distances).  The
perplexity search stays host numpy, row by row, as in the reference, and
so does Barnes-Hut (a pointer-chasing tree walk).
"""

from __future__ import annotations

import numpy as np
import torch

from ..clustering.quadtree import QuadTree
from ..clustering.vptree import VPTree
from ..device import resolve_device
from ..observability import trace
from ..ops.linalg import exact_f32_matmul


# --------------------------------------------------------------------------- shared

def _hbeta(d_row: np.ndarray, beta: float):
    """Entropy + probabilities for one row at precision beta
    (``Tsne.java hBeta:143``)."""
    p = np.exp(-d_row * beta)
    sum_p = max(p.sum(), 1e-12)
    h = np.log(sum_p) + beta * float(d_row @ p) / sum_p
    return h, p / sum_p


def _search_beta(d_row: np.ndarray, target: float, tol: float = 1e-5,
                 max_tries: int = 50) -> np.ndarray:
    """Bisect the precision beta until the row's entropy hits ``target``;
    returns the row's conditional probabilities (shared by exact and BH)."""
    beta, beta_min, beta_max = 1.0, -np.inf, np.inf
    h, p = _hbeta(d_row, beta)
    for _ in range(max_tries):
        if abs(h - target) < tol:
            break
        if h > target:
            beta_min = beta
            beta = beta * 2 if beta_max == np.inf else (beta + beta_max) / 2
        else:
            beta_max = beta
            beta = beta / 2 if beta_min == -np.inf else (beta + beta_min) / 2
        h, p = _hbeta(d_row, beta)
    return p


def binary_search_perplexity(d2: np.ndarray, perplexity: float,
                             tol: float = 1e-5, max_tries: int = 50) -> np.ndarray:
    """Per-row beta search to hit log(perplexity) entropy
    (``computeGaussianPerplexity``, ``Tsne.java:261-428``)."""
    n = d2.shape[0]
    target = np.log(perplexity)
    P = np.zeros_like(d2)
    for i in range(n):
        row = np.delete(d2[i], i)
        P[i, np.arange(n) != i] = _search_beta(row, target, tol, max_tries)
    return P


def _pairwise_sq_dists(x):
    s = torch.sum(x * x, dim=1)
    with exact_f32_matmul():
        xx = x @ x.T
    return torch.clamp(s[:, None] - 2.0 * xx + s[None, :], min=0.0)


def _tsne_grad(y, P):
    """Exact t-SNE gradient: 4 * sum_j (p_ij - q_ij) q*_ij (y_i - y_j)."""
    d2 = _pairwise_sq_dists(y)
    num = 1.0 / (1.0 + d2)
    num = num * (1.0 - torch.eye(y.shape[0], dtype=y.dtype, device=y.device))
    Q = torch.clamp(num / torch.sum(num), min=1e-12)
    PQ = (P - Q) * num
    with exact_f32_matmul():
        grad = 4.0 * ((torch.diag(PQ.sum(dim=1)) - PQ) @ y)
    kl = torch.sum(P * torch.log(torch.clamp(P, min=1e-12) / Q))
    return grad, kl


class Tsne:
    """Exact t-SNE with momentum + per-element adaptive gains
    (``Tsne.java`` step scheme)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 500,
                 early_exaggeration: float = 4.0, exaggeration_iters: int = 100,
                 seed: int = 0, *, device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.early_exaggeration = early_exaggeration
        self.exaggeration_iters = exaggeration_iters
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_: float = float("nan")

    def _input_probs(self, x: np.ndarray) -> np.ndarray:
        # once a fit: the distances on the device, the perplexity search
        # on the host over the copied matrix
        # graftlint: disable=HS01
        d2 = _pairwise_sq_dists(torch.as_tensor(
            np.asarray(x, np.float32), device=self.device)).cpu().numpy()
        with trace.span("tsne.perplexity_search", n=d2.shape[0]):
            P = binary_search_perplexity(d2, self.perplexity)
        P = (P + P.T) / (2.0 * P.shape[0])
        return np.maximum(P, 1e-12)

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        P = self._input_probs(x)
        rng = np.random.default_rng(self.seed)
        y = torch.as_tensor(
            rng.normal(0, 1e-4, (n, self.n_components)).astype(np.float32),
            device=self.device)
        return self._descend(P, y)

    def _descend(self, P: np.ndarray, y: torch.Tensor) -> np.ndarray:
        """The gradient iterations from ``y`` on ``y``'s device and in its
        dtype (float32 from ``fit_transform``): gains, momentum, the
        exaggeration dropped at ``exaggeration_iters``, the mean
        re-centred each iteration."""
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        Pj = torch.as_tensor(P * self.early_exaggeration, dtype=y.dtype,
                             device=y.device)
        kl = None
        with trace.span("tsne.iterations", n=y.shape[0], iters=self.n_iter):
            for it in range(self.n_iter):
                if it == self.exaggeration_iters:
                    Pj = Pj / self.early_exaggeration
                grad, kl = _tsne_grad(y, Pj)
                momentum = 0.5 if it < 250 else 0.8
                gains = torch.where(torch.sign(grad) != torch.sign(vel),
                                    gains + 0.2, gains * 0.8)
                gains = torch.clamp(gains, min=0.01)
                vel = momentum * vel - self.learning_rate * gains * grad
                y = y + vel
                y = y - torch.mean(y, dim=0)
            if kl is not None:
                self.kl_ = float(kl)
            return y.cpu().numpy()


class BarnesHutTsne(Tsne):
    """theta-approximate t-SNE (``BarnesHutTsne.java:36``): sparse input
    affinities from VP-tree kNN; repulsive forces via the quad tree."""

    def __init__(self, theta: float = 0.5, **kw):
        # host numpy throughout, as in the reference: no device to ask for
        kw.setdefault("device", "cpu")
        super().__init__(**kw)
        self.theta = theta

    def _sparse_input_probs(self, x: np.ndarray):
        n = x.shape[0]
        k = min(n - 1, int(3 * self.perplexity))
        tree = VPTree(x)
        rows, cols, vals = [], [], []
        for i in range(n):
            nbrs = [t for t in tree.knn(x[i], k + 1) if t[0] != i][:k]
            idx = np.array([t[0] for t in nbrs])
            d2 = np.array([t[1] for t in nbrs]) ** 2
            p = _search_beta(d2, np.log(self.perplexity))
            rows.extend([i] * len(idx))
            cols.extend(idx.tolist())
            vals.extend(p.tolist())
        P = {}
        for r, c, v in zip(rows, cols, vals):
            P[(r, c)] = P.get((r, c), 0.0) + v / (2.0 * n)
            P[(c, r)] = P.get((c, r), 0.0) + v / (2.0 * n)
        return P

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        P = self._sparse_input_probs(x)
        rng = np.random.default_rng(self.seed)
        y = rng.normal(0, 1e-4, (n, 2))
        vel = np.zeros_like(y)
        gains = np.ones_like(y)
        exagg = self.early_exaggeration
        for it in range(self.n_iter):
            if it == self.exaggeration_iters:
                exagg = 1.0
            tree = QuadTree.build(y)
            rep = np.zeros_like(y)
            sum_q = 0.0
            for i in range(n):
                f, sq = tree.compute_non_edge_forces(y[i], self.theta, i)
                rep[i] = f
                sum_q += sq
            sum_q = max(sum_q, 1e-12)
            attr = np.zeros_like(y)
            for (i, j), p in P.items():
                diff = y[i] - y[j]
                q = 1.0 / (1.0 + diff @ diff)
                attr[i] += exagg * p * q * diff
            grad = 4.0 * (attr - rep / sum_q)
            momentum = 0.5 if it < 250 else 0.8
            gains = np.where(np.sign(grad) != np.sign(vel), gains + 0.2, gains * 0.8)
            gains = np.maximum(gains, 0.01)
            vel = momentum * vel - self.learning_rate * gains * grad
            y = y + vel
            y -= y.mean(axis=0)
        return y
