"""Stochastic sampling ops over an explicit ``torch.Generator``.

Port of ``deeplearning4j_tpu/ops/sampling.py``.  Each sampler is a draw
from the generator (on the generator's device) and arithmetic on that
draw, kept apart so that the arithmetic can be fed another stream's
draws: ``jax.random.bernoulli(key, p)`` is ``uniform(key) < p``, and
``jax.random.categorical`` is the argmax of the logits plus Gumbel noise.
"""

from __future__ import annotations

import torch


def _uniform(gen, shape, dtype=torch.float32):
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def _normal(gen, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def _gumbel(gen, shape, dtype=torch.float32):
    """``-log(-log(u))`` with u uniform on [tiny, 1), as JAX draws it."""
    tiny = torch.finfo(dtype).tiny
    u = _uniform(gen, shape, dtype).clamp(min=tiny)
    return -torch.log(-torch.log(u))


def _bernoulli(u, p):
    """A Bernoulli(p) sample from uniform draws ``u``."""
    return (u < p).to(p.dtype if isinstance(p, torch.Tensor) else u.dtype)


def binomial(gen, p: torch.Tensor, n: int = 1) -> torch.Tensor:
    """Binomial(n, p) elementwise; n=1 is the Bernoulli of RBMs."""
    if n == 1:
        return _bernoulli(_uniform(gen, p.shape, p.dtype).to(p.device), p)
    u = _uniform(gen, (n,) + tuple(p.shape), p.dtype).to(p.device)
    return _bernoulli(u, p).sum(0).to(p.dtype)


def gaussian(gen, mean: torch.Tensor, std=1.0) -> torch.Tensor:
    return mean + std * _normal(gen, mean.shape, mean.dtype).to(mean.device)


def dropout_mask(gen, shape, rate: float,
                 dtype=torch.float32) -> torch.Tensor:
    """Inverted-scaling dropout mask (E[mask * x] == x), on ``gen``'s
    device."""
    if rate <= 0.0:
        return torch.ones(shape, dtype=dtype, device=gen.device)
    if rate >= 1.0:
        return torch.zeros(shape, dtype=dtype, device=gen.device)
    keep = 1.0 - rate
    return _bernoulli(_uniform(gen, shape), keep).to(dtype) / keep


def uniform(gen, shape, lo: float, hi: float,
            dtype=torch.float32) -> torch.Tensor:
    return lo + (hi - lo) * _uniform(gen, shape, dtype)


def normal(gen, shape, mean: float = 0.0, std: float = 1.0,
           dtype=torch.float32) -> torch.Tensor:
    return mean + std * _normal(gen, shape, dtype)
