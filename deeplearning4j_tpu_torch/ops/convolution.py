"""Convolution and pooling on NCHW tensors with OIHW weights.

Port of ``deeplearning4j_tpu/ops/convolution.py``: cross-correlation
with XLA's VALID/SAME padding, max and average pooling, and ``im2col``.
``F.conv2d(padding="same")`` refuses strides above 1 and pads
symmetrically, while XLA's SAME pads ``total // 2`` low and the rest
high, so SAME is computed here as explicit pads.  A float32 convolution
runs with cuDNN's TF32 off (:func:`exact_f32`), scoped to the call: the
reference's float32 is plain float32.  Its backward runs when the
gradient is taken, after the call returns, so the port's autodiff
transforms (``utils.autodiff``) take the same scope.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def exact_f32():
    """A scope in which cuDNN computes float32 convolutions in full
    float32 (TF32 off; cuDNN's other settings kept).  bf16 convolutions
    are unaffected."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=False)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_spatial(x, window, stride, padding: str, value: float = 0.0):
    """``x`` (N, C, H, W) padded for ``padding`` ("VALID" or "SAME")."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"padding must be 'VALID' or 'SAME', got {padding!r}")
    ph = same_pads(x.shape[-2], window[0], stride[0])
    pw = same_pads(x.shape[-1], window[1], stride[1])
    if not any(ph + pw):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int] = (1, 1),
           padding: str = "VALID", precision=None) -> torch.Tensor:
    """2-D cross-correlation. x: (N,C,H,W); w: (O,I,kH,kW) -> (N,O,H',W').
    ``precision`` is taken for the reference's sake: float32 is full
    float32 here."""
    xp = _pad_spatial(x, w.shape[-2:], tuple(stride), padding)
    with exact_f32():
        return F.conv2d(xp, w, stride=tuple(stride))


def max_pool(x: torch.Tensor, window: Sequence[int],
             stride: Sequence[int] | None = None,
             padding: str = "VALID") -> torch.Tensor:
    """Max pooling over the trailing two (spatial) dims of an NCHW tensor."""
    stride = tuple(stride) if stride is not None else tuple(window)
    xp = _pad_spatial(x, window, stride, padding, value=-torch.inf)
    return F.max_pool2d(xp, tuple(window), stride)


def avg_pool(x: torch.Tensor, window: Sequence[int],
             stride: Sequence[int] | None = None,
             padding: str = "VALID") -> torch.Tensor:
    """Average pooling; SAME divides each window by its count of real
    (unpadded) elements, as the reference does."""
    stride = tuple(stride) if stride is not None else tuple(window)
    area = window[0] * window[1]
    summed = F.avg_pool2d(_pad_spatial(x, window, stride, padding),
                          tuple(window), stride) * area
    if padding == "VALID":
        return summed / area
    ones = torch.ones_like(x[:1, :1])
    counts = F.avg_pool2d(_pad_spatial(ones, window, stride, padding),
                          tuple(window), stride) * area
    return summed / counts


def im2col(x: torch.Tensor, kh: int, kw: int, stride: Sequence[int] = (1, 1),
           padding: str = "VALID") -> torch.Tensor:
    """Sliding patches: (N,C,H,W) -> (N, C*kh*kw, L) over the L output
    positions, channel-major within a patch."""
    xp = _pad_spatial(x, (kh, kw), tuple(stride), padding)
    return F.unfold(xp, (kh, kw), stride=tuple(stride))
