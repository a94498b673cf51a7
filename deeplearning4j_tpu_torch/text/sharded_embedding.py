"""Embedding tables row-split over the ``ep`` mesh axis: distributed
Word2Vec and GloVe training.

Port of ``deeplearning4j_tpu/text/sharded_embedding.py`` (the reference's
distributed sparse-embedding strategy, ``Word2VecWork.java`` +
``Word2VecPerformer.java:72-137``, GloVe's ``GlovePerformer.java``:
workers receive only the rows their sentences touch and return per-row
deltas), SPMD over the ranks of an ``ep`` axis:

- **tables row-split**: syn0/syn1/syn1neg (GloVe: all eight tables) live
  as ``P('ep', None)`` blocks, each rank owning ``rows / ep`` rows, so the
  vocabulary scales with the ranks;
- **row shipping = masked gather + psum**: every rank gathers the batch's
  rows it owns (the others contribute zeros) and ``psum``-s them over
  ``ep`` — the collective IS the row shipment;
- **per-row deltas = masked scatter-add**: after the (identical,
  replicated) delta computation each rank adds only the rows it owns.
  Repeated indices in a batch accumulate exactly, with
  ``index_put_(accumulate=True)``, as the one-device step does.

The batch (center/context/path indices) is the same on every rank: the
schedule, vocabulary, Huffman tree and draws are the one-device model's,
so the sharded fit matches ``Word2Vec``/``Glove`` to float tolerance.
Every rank of the world builds the model (the mesh is collective); a
rank outside the mesh trains nothing.  Tables are updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import collectives as clv
from ..parallel.mesh import EP, NamedSharding, P, global_block, local_block
from .glove import Glove
from .word2vec import Word2Vec, _host


def pad_rows(n: int, n_shards: int) -> int:
    """Rows padded up so each shard owns an equal slice."""
    return ((max(n, 1) + n_shards - 1) // n_shards) * n_shards


def _owned(idx, axis: str, rows_per: int):
    """(local row of each global index, clamped; whether this rank owns
    it)."""
    loc = idx - clv.axis_index(axis) * rows_per
    valid = (loc >= 0) & (loc < rows_per)
    return loc.clamp(0, rows_per - 1), valid


def gather_rows(table, idx, axis: str, rows_per: int):
    """Whole rows for global indices from a row-split table: a local
    masked gather and a psum over the shard axis (the row shipping)."""
    loc, valid = _owned(idx, axis, rows_per)
    rows = table[loc]
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    return clv.psum(rows, axis)


def scatter_add_rows(table, idx, upd, axis: str, rows_per: int):
    """Add per-row deltas to the locally owned rows only, in place."""
    loc, valid = _owned(idx, axis, rows_per)
    upd = torch.where(valid[..., None], upd, torch.zeros_like(upd))
    table.index_put_((loc,), upd, accumulate=True)
    return table


def _gather_vec(vec, idx, axis: str, rows_per: int):
    """:func:`gather_rows` for 1-d tables (GloVe's biases)."""
    loc, valid = _owned(idx, axis, rows_per)
    vals = vec[loc]
    return clv.psum(torch.where(valid, vals, torch.zeros_like(vals)), axis)


def _scatter_add_vec(vec, idx, upd, axis: str, rows_per: int):
    loc, valid = _owned(idx, axis, rows_per)
    vec.index_put_((loc,), torch.where(valid, upd, torch.zeros_like(upd)),
                   accumulate=True)
    return vec


# ------------------------------------------------------------ step builders

def build_hs_step(mesh, rows0: int, rows1: int):
    """Sharded hierarchical-softmax skip-gram step (the semantics of
    ``InMemoryLookupTable.java:182-222`` at batch granularity):
    ``step(syn0, syn1, centers, points, codes, mask, alpha)`` on this
    rank's blocks, in place."""
    n_ep = mesh.shape[EP]
    r0, r1 = rows0 // n_ep, rows1 // n_ep

    def step(syn0, syn1, centers, points, codes, mask, alpha):
        with mesh:
            h = gather_rows(syn0, centers, EP, r0)            # (B, D)
            w = gather_rows(syn1, points, EP, r1)             # (B, L, D)
            u = torch.einsum("bd,bld->bl", h, w)
            g = (1.0 - codes - torch.sigmoid(u)) * alpha * mask
            dh = torch.einsum("bl,bld->bd", g, w)
            dw = g[:, :, None] * h[:, None, :]
            scatter_add_rows(syn1, points, dw, EP, r1)
            scatter_add_rows(syn0, centers, dh, EP, r0)
        return syn0, syn1

    return step


def build_ns_step(mesh, rows0: int, rows1: int):
    """Sharded negative-sampling step (``InMemoryLookupTable.java:225-266``):
    ``step(syn0, syn1neg, centers, targets, labels, alpha)``, in place."""
    n_ep = mesh.shape[EP]
    r0, r1 = rows0 // n_ep, rows1 // n_ep

    def step(syn0, syn1neg, centers, targets, labels, alpha):
        with mesh:
            h = gather_rows(syn0, centers, EP, r0)
            w = gather_rows(syn1neg, targets, EP, r1)
            u = torch.einsum("bd,bkd->bk", h, w)
            g = (labels - torch.sigmoid(u)) * alpha
            dh = torch.einsum("bk,bkd->bd", g, w)
            dw = g[:, :, None] * h[:, None, :]
            scatter_add_rows(syn1neg, targets, dw, EP, r1)
            scatter_add_rows(syn0, centers, dh, EP, r0)
        return syn0, syn1neg

    return step


def build_glove_step(mesh, rows: int, lr: float):
    """Sharded GloVe AdaGrad step (``GloveWeightLookupTable.java``'s
    weighted least squares): ``step(w, wc, b, bc, hw, hwc, hb, hbc, rows_i,
    cols_i, logx, fx) -> loss`` on this rank's blocks, in place; the
    accumulators are read AFTER this batch's squared gradients are added,
    as the reference does."""
    r = rows // mesh.shape[EP]

    def step(w, wc, b, bc, hw, hwc, hb, hbc, rows_i, cols_i, logx, fx):
        with mesh:
            wi = gather_rows(w, rows_i, EP, r)
            wj = gather_rows(wc, cols_i, EP, r)
            bi = _gather_vec(b, rows_i, EP, r)
            bj = _gather_vec(bc, cols_i, EP, r)
            diff = torch.einsum("bd,bd->b", wi, wj) + bi + bj - logx
            wdiff = fx * diff
            gw = wdiff[:, None] * wj
            gwc = wdiff[:, None] * wi
            gb = wdiff
            scatter_add_rows(hw, rows_i, gw * gw, EP, r)
            scatter_add_rows(hwc, cols_i, gwc * gwc, EP, r)
            _scatter_add_vec(hb, rows_i, gb * gb, EP, r)
            _scatter_add_vec(hbc, cols_i, gb * gb, EP, r)
            hw_g = gather_rows(hw, rows_i, EP, r)
            hwc_g = gather_rows(hwc, cols_i, EP, r)
            hb_g = _gather_vec(hb, rows_i, EP, r)
            hbc_g = _gather_vec(hbc, cols_i, EP, r)
            scatter_add_rows(w, rows_i, -lr * gw * torch.rsqrt(hw_g + 1e-8),
                             EP, r)
            scatter_add_rows(wc, cols_i,
                             -lr * gwc * torch.rsqrt(hwc_g + 1e-8), EP, r)
            _scatter_add_vec(b, rows_i, -lr * gb * torch.rsqrt(hb_g + 1e-8),
                             EP, r)
            _scatter_add_vec(bc, cols_i,
                             -lr * gb * torch.rsqrt(hbc_g + 1e-8), EP, r)
        return 0.5 * torch.mean(fx * diff * diff)

    return step


def _check_mesh(mesh) -> None:
    if EP not in mesh.shape or mesh.shape[EP] < 1:
        raise ValueError(f"mesh must carry an {EP!r} axis")


# ------------------------------------------------------------------- models

class ShardedWord2Vec(Word2Vec):
    """Word2Vec with its tables row-split over the mesh's ``ep`` axis.

    Same schedule, vocabulary, Huffman tree and hyperparameters as the
    one-device model — only the tables' placement and the update steps
    change, so the fit matches ``Word2Vec``'s.  During a fit ``syn0``,
    ``syn1`` and ``syn1neg`` are this rank's blocks; after it they are
    the whole (padded) tables, gathered from the ranks, so the query API
    reads them as the one-device model's."""

    def __init__(self, sentences=None, *, mesh, **kw):
        super().__init__(sentences, **kw)
        _check_mesh(mesh)
        self.mesh = mesh
        self._hs_fn = self._ns_fn = None

    def _block(self, table):
        return local_block(table, NamedSharding(self.mesh, P(EP, None)))

    def reset_weights(self) -> None:
        n_ep = self.mesh.shape[EP]
        n, d = len(self.vocab), self.layer_size
        n0, n1 = pad_rows(n, n_ep), pad_rows(max(n - 1, 1), n_ep)
        rng = np.random.default_rng(self.seed)
        syn0 = np.zeros((n0, d), np.float32)
        syn0[:n] = (rng.random((n, d), np.float32) - 0.5) / d
        dev = self.device
        self.syn0 = torch.as_tensor(self._block(syn0), device=dev).clone()
        self.syn1 = torch.zeros((n1 // n_ep, d), dtype=torch.float32,
                                device=dev)
        self._hs_fn = build_hs_step(self.mesh, n0, n1)
        if self.negative > 0:
            n1n = pad_rows(n, n_ep)
            self.syn1neg = torch.zeros((n1n // n_ep, d), dtype=torch.float32,
                                       device=dev)
            counts = self.vocab.counts_array() ** 0.75
            self._unigram = torch.as_tensor(
                counts / counts.sum(), dtype=torch.float32, device=dev)
            self._ns_fn = build_ns_step(self.mesh, n0, n1n)

    def _apply_hs(self, cb, pts, cds, msk, alpha):
        self._hs_fn(self.syn0, self.syn1, cb, pts, cds, msk, alpha)

    def _apply_ns(self, cb, targets, labels, alpha):
        self._ns_fn(self.syn0, self.syn1neg, cb, targets, labels, alpha)

    def fit(self) -> "ShardedWord2Vec":
        if not self.mesh.member:
            return self
        if self.syn0 is not None and self._hs_fn is None:
            raise RuntimeError("the tables are gathered after a fit: a "
                               "sharded model fits once")
        super().fit()
        whole = NamedSharding(self.mesh, P(EP, None))
        self.syn0 = global_block(self.syn0, whole)
        self.syn1 = global_block(self.syn1, whole)
        if self.syn1neg is not None:
            self.syn1neg = global_block(self.syn1neg, whole)
        self._hs_fn = self._ns_fn = None
        return self

    @property
    def embeddings(self) -> np.ndarray:
        """(n_vocab, D) host array — trims the shard padding."""
        return _host(self.syn0[:len(self.vocab)])


class ShardedGlove(Glove):
    """GloVe with all eight tables row-split over ``ep``; after a fit
    ``syn0`` is the whole (trimmed) embedding, as the one-device model's."""

    def __init__(self, sentences=None, *, mesh, **kw):
        super().__init__(sentences, **kw)
        _check_mesh(mesh)
        self.mesh = mesh
        self._step_fn = None
        self._n_pad = 0

    def _init_tables(self, n: int, d: int, rng) -> None:
        n_ep = self.mesh.shape[EP]
        self._n_pad = pad_rows(n, n_ep)
        w = np.zeros((self._n_pad, d), np.float32)
        wc = np.zeros((self._n_pad, d), np.float32)
        w[:n] = (rng.random((n, d), np.float32) - 0.5) / d
        wc[:n] = (rng.random((n, d), np.float32) - 0.5) / d
        dev, r = self.device, self._n_pad // n_ep
        t = NamedSharding(self.mesh, P(EP, None))

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        self._tables = [torch.as_tensor(local_block(w, t), device=dev).clone(),
                        torch.as_tensor(local_block(wc, t),
                                        device=dev).clone(),
                        zeros(r), zeros(r), zeros(r, d), zeros(r, d),
                        zeros(r), zeros(r)]
        self._step_fn = build_glove_step(self.mesh, self._n_pad,
                                         self.learning_rate)

    def _apply_step(self, rows, cols, logx, fx):
        """One sharded AdaGrad batch; returns the DEVICE loss, which
        ``fit`` reads at its own fence."""
        return self._step_fn(*self._tables, rows, cols, logx, fx)

    def _final_embeddings(self, n: int):
        t = NamedSharding(self.mesh, P(EP, None))
        w = global_block(self._tables[0], t)
        wc = global_block(self._tables[1], t)
        return (w + wc)[:n]

    def fit(self) -> "ShardedGlove":
        if not self.mesh.member:
            return self
        return super().fit()
