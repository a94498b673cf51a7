"""Dtype policy: a parameter dtype and a compute dtype.

Port of ``deeplearning4j_tpu/ops/dtypes.py`` with torch dtypes.  The
parameter dtype is float32 by default; the compute dtype is float32 or,
under :func:`bf16_compute`, bfloat16 for the matmuls (Hopper's tensor
cores), with float32 parameters.
"""

from __future__ import annotations

import dataclasses

import torch


def _dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"bfloat16"``)."""
    if isinstance(d, torch.dtype):
        return d
    name = getattr(d, "name", None) or str(d)
    return getattr(torch, name.removeprefix("torch."))


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    def cast_compute(self, x):
        return x.to(self.compute_dtype) if isinstance(x, torch.Tensor) else x

    def cast_param(self, x):
        return x.to(self.param_dtype) if isinstance(x, torch.Tensor) else x


_POLICY = DtypePolicy()


def get_policy() -> DtypePolicy:
    return _POLICY


def set_policy(param_dtype=None, compute_dtype=None) -> DtypePolicy:
    """Set the process-wide dtype policy (a torch dtype or its name)."""
    global _POLICY
    _POLICY = DtypePolicy(
        param_dtype=(_dtype(param_dtype) if param_dtype is not None
                     else _POLICY.param_dtype),
        compute_dtype=(_dtype(compute_dtype) if compute_dtype is not None
                       else _POLICY.compute_dtype),
    )
    return _POLICY


def bf16_compute() -> DtypePolicy:
    """bfloat16 matmuls with float32 parameters (mixed precision)."""
    return set_policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
