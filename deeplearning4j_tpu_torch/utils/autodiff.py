"""JAX's function transforms over parameter trees, in ``torch.func``.

The reference differentiates pure functions of pytrees with
``jax.value_and_grad``, ``jax.jvp`` and ``jax.vjp``; the port's
parameter trees (tuples, lists and dicts of tensors) go through
``torch.func`` the same way, so the layer stack stays functional.  Each
transform runs its forward and its backward with cuDNN's TF32 off
(``ops.convolution.exact_f32``): a float32 convolution's backward runs
here, after the convolution's own call has returned.
"""

from __future__ import annotations

import torch

from ..ops.convolution import exact_f32


def value_and_grad(fn, argnums: int = 0):
    """``fn``'s value and its gradient w.r.t. argument ``argnums``:
    ``value_and_grad(fn)(*args) -> (value, grads)``, as in JAX."""
    inner = torch.func.grad_and_value(fn, argnums=argnums)

    def wrapped(*args, **kwargs):
        with exact_f32():
            grads, value = inner(*args, **kwargs)
        return value, grads

    return wrapped


def grad(fn, argnums: int = 0):
    inner = torch.func.grad(fn, argnums=argnums)

    def wrapped(*args, **kwargs):
        with exact_f32():
            return inner(*args, **kwargs)

    return wrapped


def jvp(fn, primals: tuple, tangents: tuple):
    """``(fn(*primals), d fn . tangents)`` (forward mode)."""
    with exact_f32():
        return torch.func.jvp(fn, primals, tangents)


def vjp(fn, *primals):
    """``(fn(*primals), vjp_fn)`` with ``vjp_fn(cotangent) -> tuple``."""
    with exact_f32():
        out, inner = torch.func.vjp(fn, *primals)

    def vjp_fn(cotangent):
        with exact_f32():
            return inner(cotangent)

    return out, vjp_fn
