"""Operators of the port: the DL4J tensor substrate (activations, losses,
convolution, linalg, sampling, rng, dtypes) and, in ``ops.cuda``, the
hand-written CUDA kernels."""

from . import activations, convolution, dtypes, linalg, losses, rng, sampling
from .dtypes import DtypePolicy, get_policy, set_policy
from .losses import LossFunction
from .rng import RngStream

__all__ = [
    "activations", "convolution", "dtypes", "linalg", "losses", "rng",
    "sampling", "DtypePolicy", "get_policy", "set_policy", "LossFunction",
    "RngStream",
]
