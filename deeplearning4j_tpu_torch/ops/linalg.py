"""BLAS-contract ops: ``gemm`` under the dtype policy, ``dot``, ``axpy``,
``iamax``, ``nrm2`` and ``to_flattened``.

Port of ``deeplearning4j_tpu/ops/linalg.py``.  ``gemm`` rounds its operands
to the policy's compute dtype and accumulates in float32; the in-place BLAS ``axpy`` is a functional return.
"""

from __future__ import annotations

import torch

from .dtypes import get_policy


def gemm(a: torch.Tensor, b: torch.Tensor, precision=None) -> torch.Tensor:
    """Matrix multiply of the operands rounded to the policy's compute
    dtype, accumulated and returned in float32, then cast to the parameter
    dtype.  ``precision`` is taken for the reference's sake: a float32
    product is full float32 here (TF32 stays off)."""
    policy = get_policy()
    out = torch.matmul(policy.cast_compute(a).float(),
                       policy.cast_compute(b).float())
    return out.to(policy.param_dtype)


mmul = gemm


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.reshape(-1) * y.reshape(-1))


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + alpha*x (functional form of BLAS axpy)."""
    return y + alpha * x


def iamax(x: torch.Tensor) -> torch.Tensor:
    """Index of the max-|value| element (argmax over flattened input)."""
    return torch.argmax(torch.abs(x.reshape(-1)))


def nrm2(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


def to_flattened(arrays) -> torch.Tensor:
    """Concatenate raveled arrays (``Nd4j.toFlattened``)."""
    return torch.cat([a.reshape(-1) for a in arrays])
