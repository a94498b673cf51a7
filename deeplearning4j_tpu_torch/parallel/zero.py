"""ZeRO layout: the flattened, padded view of a param tree that the
sharded weight update trains in.

Port of ``deeplearning4j_tpu/parallel/zero.py``.  Every leaf of the
natural param tree maps to a 1-D vector zero-padded to a multiple of the
dp width, so the ``P('dp')`` placement gives each rank one contiguous,
equal-size chunk per leaf.  Optimizer-state leaves mirror the flat tree
(the ``state_spec`` contract of ``optimize/transforms``), which makes the
rank-local ``transform.update`` exact: every transform here is
elementwise over its leaves, so updating 1/ndp of the elements on each
rank computes the numbers the replicated update would — padding carries
zero gradients and is sliced off before the natural view is rebuilt.

The layout is metadata (``meta`` tensors: shapes and dtypes, no memory):
``flatten_tree`` / ``unflatten_like`` / ``chunk_tree`` work on this
rank's tensors, and the host helpers gather a rank's chunks over the
active mesh's dp axis (``to_natural_host``) or take a rank's chunks of a
natural tree (``place_flat``), so the on-disk format is the same at every
stage and width.  The module-level host helpers re-split a flat
checkpoint leaf written at one width for another, exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..optimize import transforms as tfm
from ..utils.tree_math import tree_map
from . import collectives as clv
from .mesh import DP, NamedSharding, P, local_block


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _size(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def flat_padded_size(size: int, n_dp: int) -> int:
    """Length of a natural leaf of ``size`` elements in the flat padded
    layout at width ``n_dp``: dp-divisible, never empty."""
    return max(_round_up(size, n_dp), n_dp)


def host_flat_to_natural(arr: np.ndarray, shape, saved_dp: int) -> np.ndarray:
    """Exact host-side re-split of one flat padded leaf back to its natural
    shape.  Raises ValueError when the length is not the padded length of
    ``shape`` at ``saved_dp``."""
    arr = np.asarray(arr)
    size = _size(shape)
    want = flat_padded_size(size, saved_dp)
    if arr.ndim != 1 or arr.shape[0] != want:
        raise ValueError(
            f"flat leaf has shape {arr.shape}, expected ({want},) for "
            f"natural shape {tuple(shape)} at saved dp={saved_dp}")
    return arr[:size].reshape(shape)


def host_natural_to_flat(arr: np.ndarray, n_dp: int) -> np.ndarray:
    """Exact host-side flatten+pad of one natural leaf for width ``n_dp``."""
    flat = np.asarray(arr).reshape(-1)
    pad = flat_padded_size(flat.shape[0], n_dp) - flat.shape[0]
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), flat.dtype)])
    return flat


def _meta(tree):
    return tree_map(lambda a: torch.empty(tuple(a.shape), dtype=a.dtype,
                                          device="meta")
                    if torch.is_tensor(a) else a, tree)


class ZeroLayout:
    """Flatten/pad/shard metadata for one (mesh, transform, params).

    Built once at ``init_state`` from shapes only (``meta`` tensors):
    ``natural_params`` / ``natural_tstate`` are the natural trees'
    shapes, ``flat_sharding`` the ``P('dp')`` placement of a flat leaf,
    ``state_shardings`` the placement tree of the flat optimizer state,
    and ``decay_mask`` the weight-class leaves by their natural shapes."""

    def __init__(self, mesh, transform: tfm.GradientTransform, params):
        self.mesh = mesh
        self.n_dp = int(mesh.shape[DP])
        self.transform = transform
        self.natural_params = _meta(params)
        self.natural_tstate = transform.init(self.natural_params)
        self.flat_sharding = NamedSharding(mesh, P(DP))
        flat_params = self.flatten_tree(self.natural_params)
        self.state_shardings = tfm.state_shardings(
            transform, flat_params, P(DP), mesh)
        # weight-decay classification comes from the NATURAL layout: the
        # ndim >= 2 heuristic is meaningless on 1-D chunks, so the sharded
        # step pushes this mask through decay_mask_override
        self.decay_mask = tree_map(lambda a: a.dim() >= 2, self.natural_params)

    # ---------------------------------------------------------- per-leaf ops
    def padded_size(self, size: int) -> int:
        """Leaf length after zero-padding: dp-divisible, never empty."""
        return flat_padded_size(size, self.n_dp)

    def chunk_size(self, size: int) -> int:
        return self.padded_size(size) // self.n_dp

    def _flatten_leaf(self, x):
        flat = x.reshape(-1)
        pad = self.padded_size(flat.shape[0]) - flat.shape[0]
        if pad:
            flat = torch.cat([flat, flat.new_zeros((pad,))])
        return flat

    # ---------------------------------------------------------- tree ops
    def flatten_tree(self, tree):
        """Natural -> flat padded, leaf by leaf (params and the optimizer
        state alike: state leaves mirror param shapes)."""
        return tree_map(lambda x: self._flatten_leaf(x)
                        if torch.is_tensor(x) else x, tree)

    def unflatten_like(self, flat_tree, natural_template):
        """Flat padded -> natural shapes: slice the pad off, reshape to the
        template leaf's shape."""
        return tree_map(
            lambda v, t: v[:_size(t.shape)].reshape(t.shape)
            if torch.is_tensor(v) else v, flat_tree, natural_template)

    def chunk_tree(self, flat_tree, idx, natural_template):
        """Rank ``idx``'s contiguous chunk of every flat leaf."""
        def chunk(v, t):
            if not torch.is_tensor(v):
                return v
            k = self.chunk_size(_size(t.shape))
            return v[idx * k:(idx + 1) * k]

        return tree_map(chunk, flat_tree, natural_template)

    # ---------------------------------------------------------- host ops
    def to_natural_host(self, flat_tree, natural_template):
        """This rank's flat chunks gathered over dp (collective: every
        member calls it) and rebuilt in natural shapes on the host — the
        width-agnostic checkpoint payload.  Non-tensor leaves pass."""
        with self.mesh:
            full = tree_map(
                lambda v: clv.all_gather_or_identity(v, DP, self.n_dp)
                if torch.is_tensor(v) else v, flat_tree)
        return tree_map(
            lambda v, t: v[:_size(t.shape)].reshape(t.shape).cpu()
            if torch.is_tensor(v) else v, full, natural_template)

    def place_flat(self, natural_tree, out_shardings, device=None):
        """Natural-layout tensors -> flat padded leaves, each placed per
        ``out_shardings`` (a sharding, or a tree of them): a ``P('dp')``
        leaf keeps this rank's chunk.  The restore path: whatever width
        wrote the checkpoint, the current mesh takes its chunks."""
        flat = self.flatten_tree(natural_tree)
        if isinstance(out_shardings, NamedSharding):
            out_shardings = tree_map(lambda _: out_shardings, flat)

        def place(v, sh):
            if not torch.is_tensor(v):
                return v
            v = local_block(v, sh)
            return v.to(device).clone() if device is not None else v.clone()

        return tree_map(place, flat, out_shardings)
