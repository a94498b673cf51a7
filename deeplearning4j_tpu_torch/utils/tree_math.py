"""Parameter trees (nested dicts, lists and tuples of tensors) and their
arithmetic.

A port of ``deeplearning4j_tpu/utils/tree_math.py`` (``add``, ``sub``,
``scale``, ``axpy``, ``dot``, ``norm2``, ``neg``, ``zeros_like``,
``max_abs``, ``clip_by_global_norm``, ``unit_norm``), plus the three tree walks JAX's ``tree_util`` gave the reference:
:func:`tree_leaves`, :func:`tree_unflatten` and :func:`tree_map`.  Dict
keys are visited in sorted order, as ``jax.tree_util`` visits them; an
empty tuple is an empty subtree.  Everything else (a tensor, a bool) is a
leaf.
"""

from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, depth first, dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_unflatten(like, leaves) -> object:
    """A tree of ``like``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}          # keep the key order
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def add(a, b):
    return tree_map(torch.add, a, b)


def sub(a, b):
    return tree_map(torch.sub, a, b)


def scale(s, a):
    return tree_map(lambda x: s * x, a)


def axpy(s, a, b):
    """b + s*a."""
    return tree_map(lambda x, y: y + s * x, a, b)


def dot(a, b) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def norm2(a) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def neg(a):
    return tree_map(torch.neg, a)


def zeros_like(a):
    return tree_map(torch.zeros_like, a)


def max_abs(a) -> torch.Tensor:
    return torch.stack([x.abs().max() for x in tree_leaves(a)]).max()


def clip_by_global_norm(a, max_norm: float):
    """``a`` scaled by ``min(1, max_norm / ||a||)`` (no host sync)."""
    factor = torch.clamp(max_norm / (norm2(a) + 1e-12), max=1.0)
    return scale(factor, a)


def unit_norm(a):
    """Scale to unit L2 norm (``constrainGradientToUnitNorm``)."""
    return scale(1.0 / (norm2(a) + 1e-12), a)
