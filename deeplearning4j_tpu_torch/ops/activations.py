"""Activation functions and their derivatives.

Port of ``deeplearning4j_tpu/ops/activations.py``: a registry of
elementwise activations (``softmax`` and ``logsoftmax`` row-wise) with
explicit derivatives where the reference has them, ``apply`` and
``apply_derivative``.  Training differentiates through the activations
with autograd; the explicit derivatives exist for the API and the tests.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: dict[str, Activation] = {}
_DERIVATIVES: dict[str, Activation] = {}
# Row-wise activations: an elementwise derivative means nothing for these,
# so they must have an explicit derivative or be refused.
_ROWWISE = {"logsoftmax"}


def register(name: str, fn: Activation, deriv: Activation | None = None):
    _REGISTRY[name] = fn
    if deriv is not None:
        _DERIVATIVES[name] = deriv
    return fn


def get(name: str) -> Activation:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; known: "
                         f"{sorted(_REGISTRY)}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


def apply(name: str, x: torch.Tensor) -> torch.Tensor:
    return get(name)(x)


def apply_derivative(name: str, x: torch.Tensor) -> torch.Tensor:
    """Elementwise derivative f'(x).

    For ``softmax`` this is the diagonal y*(1-y) of the reference's delta
    chain (the full Jacobian is autograd's business)."""
    if name in _DERIVATIVES:
        return _DERIVATIVES[name](x)
    if name in _ROWWISE:
        raise ValueError(
            f"activation {name!r} is row-wise (not elementwise); its full "
            "Jacobian is handled by autograd in the training path — "
            "apply_derivative has no elementwise meaning for it")
    fn = get(name)
    flat = x.reshape(-1)
    d = torch.func.vmap(torch.func.grad(lambda v: fn(v.reshape(1))[0]))(flat)
    return d.reshape(x.shape)


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def _ones(x):
    return torch.ones_like(x)


register("sigmoid", torch.sigmoid,
         lambda x: torch.sigmoid(x) * (1 - torch.sigmoid(x)))
register("tanh", torch.tanh, lambda x: 1 - torch.tanh(x) ** 2)
register("relu", torch.relu, lambda x: (x > 0).to(x.dtype))
register("leakyrelu", lambda x: F.leaky_relu(x, 0.01),
         lambda x: torch.where(x > 0, 1.0, 0.01).to(x.dtype))
register("linear", lambda x: x, _ones)
register("identity", lambda x: x, _ones)
register("exp", torch.exp, torch.exp)
register("softsign", F.softsign, lambda x: 1.0 / (1.0 + torch.abs(x)) ** 2)
register("softplus", F.softplus, torch.sigmoid)
register("hardtanh", lambda x: torch.clamp(x, -1.0, 1.0),
         lambda x: ((x > -1.0) & (x < 1.0)).to(x.dtype))
register("gelu", lambda x: F.gelu(x, approximate="tanh"))
register("softmax", softmax, lambda x: softmax(x) * (1 - softmax(x)))
register("logsoftmax", lambda x: torch.log_softmax(x, dim=-1))
