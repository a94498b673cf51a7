"""Weight initialization schemes.

Port of ``deeplearning4j_tpu/nn/weights.py``: VI (Glorot-like fan-sum
uniform), ZERO, SIZE, DISTRIBUTION, NORMALIZED, UNIFORM.  Every init
draws from an explicit ``torch.Generator`` on the generator's device
(torch cannot reproduce threefry streams: parameters cross between the
packages through numpy, ``models.convert``).
"""

from __future__ import annotations

import math

import torch

from ..ops.dtypes import get_policy
from .conf import Distribution, NeuralNetConfiguration, WeightInit


def init_weights(gen, shape: tuple[int, ...], scheme: WeightInit,
                 dist: Distribution = Distribution.NORMAL,
                 dist_std: float = 1e-2, dtype=None) -> torch.Tensor:
    """A weight tensor of ``shape`` per the named scheme, on ``gen``'s
    device.  VI is U(-r, r) with r = sqrt(6) / sqrt(fan_in + fan_out + 1)."""
    dtype = dtype or get_policy().param_dtype
    dev = gen.device
    fan_in = shape[0] if len(shape) >= 1 else 1
    fan_out = shape[-1] if len(shape) >= 2 else 1
    scheme = WeightInit(scheme)

    def uniform(lo, hi):
        u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
        return (lo + (hi - lo) * u).to(dtype)

    def normal():
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    if scheme == WeightInit.ZERO:
        return torch.zeros(shape, dtype=dtype, device=dev)
    if scheme == WeightInit.VI:
        r = math.sqrt(6.0) / math.sqrt(fan_in + fan_out + 1.0)
        return uniform(-r, r)
    if scheme == WeightInit.SIZE:
        return (normal() / math.sqrt(float(fan_in))).to(dtype)
    if scheme == WeightInit.UNIFORM:
        a = 1.0 / float(fan_in)
        return uniform(-a, a)
    if scheme == WeightInit.NORMALIZED:
        w = uniform(0.0, 1.0)
        return (w - w.mean()) / (w.std(correction=0) + 1e-12)
    if scheme == WeightInit.DISTRIBUTION:
        if Distribution(dist) == Distribution.UNIFORM:
            return uniform(-dist_std, dist_std)
        return (dist_std * normal()).to(dtype)
    raise ValueError(f"unknown weight init {scheme}")


def init_from_conf(gen, shape: tuple[int, ...], conf: NeuralNetConfiguration,
                   dtype=None) -> torch.Tensor:
    return init_weights(gen, shape, conf.weight_init, conf.dist,
                        conf.dist_std, dtype)
