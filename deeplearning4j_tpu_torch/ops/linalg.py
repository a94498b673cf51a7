"""BLAS-contract ops: ``gemm`` under the dtype policy, ``dot``, ``axpy``,
``iamax``, ``nrm2`` and ``to_flattened``.

Port of ``deeplearning4j_tpu/ops/linalg.py``.  ``gemm`` rounds its operands
to the policy's compute dtype and accumulates in float32; the in-place BLAS ``axpy`` is a functional return.
:func:`exact_f32_matmul` scopes full float32 products (no TF32) for code
whose answer turns on cancellation, such as ``|p|^2 - 2 p.c + |c|^2``.
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def exact_f32_matmul():
    """A scope in which float32 matrix products run in full float32
    (``"highest"``: no TF32 on the card), whatever the process has set;
    the setting is restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


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
