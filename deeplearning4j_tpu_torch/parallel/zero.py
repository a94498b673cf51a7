"""Host-side arithmetic of the ZeRO flat layout.

The part of ``deeplearning4j_tpu/parallel/zero.py`` a checkpoint restore
needs: in the flat padded ``P('dp')`` layout every leaf of the natural
tree is a 1-D vector zero-padded to a multiple of the dp width.  A
checkpoint written in that layout at one width restores at another by
slicing the padding off on the host (exact: the padding is zeros by
construction).  The sharded weight update itself (ZeRO stages 1-3) comes
with the multi-device port (``ROADMAP.md`` A10).
"""

from __future__ import annotations

import numpy as np


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
