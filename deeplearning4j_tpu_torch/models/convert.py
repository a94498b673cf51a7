"""Parameter trees between the JAX package and the port, through numpy.

The caller turns the JAX tree into numpy arrays itself
(``jax.tree_util.tree_map(np.asarray, params)``) — this module imports
nothing of JAX.  Names and layouts are the same in both packages, so the
conversion is a key-by-key copy of any nesting, the parameter tree and
the ``{"backbone", "head"}`` finetune tree alike.  A ``QuantizedLinear``
in the numpy tree (a named pair ``q``/``scale``) becomes the port's
``QuantizedLinear``.
bfloat16 arrays (numpy's ml_dtypes extension type) travel as float32 and
are cast back to bfloat16 on the torch side; :func:`params_to_numpy`
returns bfloat16 tensors as float32 arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda.matmul_int8 import QuantizedLinear


def _leaf_to_torch(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(dev)


def params_from_numpy(tree, device=None):
    """A nested dict/list/tuple of numpy arrays → the same tree of torch
    tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields") \
                and tuple(node._fields) == ("q", "scale"):
            return QuantizedLinear(q=conv(node.q), scale=conv(node.scale))
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _leaf_to_torch(node, dev)

    return conv(tree)


def params_to_numpy(tree):
    """The port's tree → the same tree of numpy arrays (host copies)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, QuantizedLinear):
            return QuantizedLinear(q=conv(node.q), scale=conv(node.scale))
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    return conv(tree)
