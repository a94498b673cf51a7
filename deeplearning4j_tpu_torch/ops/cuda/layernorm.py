"""Fused residual add + LayerNorm: the forward as a CUDA kernel.

Port of ``deeplearning4j_tpu/ops/pallas/layernorm.py``.  The transformer
block's mid-sublayer seam ``x = x + proj; h = LN(x)`` becomes one pass
that reads x and r once and writes y and h once:
``y = x + r * mask``, ``h = LN(y) * scale + bias`` in f32, both outputs
in x's dtype, h normalized from the unrounded f32 y.

- :func:`reference_residual_layernorm` is the plain version (and the
  kernel's CPU path).
- :func:`fused_residual_layernorm` is the differentiable wrapper: a
  ``torch.autograd.Function`` whose forward is ``csrc/residual_layernorm.cu``
  (counted in ``fused_residual_layernorm.launches``) and whose backward is
  the JAX package's ``_fused_bwd`` (the LN gradient from the saved, rounded
  y) in torch ops.  On a CUDA tensor the kernel runs or the call raises.
- :func:`_unfused` is the torch incumbent: the two-op seam (residual add
  in x's dtype, then the f32 LN).
"""

from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from ...observability import tracing as trace
from ...observability.cost import kernel_work
from . import build, registry

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
#: dl4j_residual_layernorm(x, r, mask, scale, bias, y, h, N, D, eps, dtype,
#: stream)
_ARGTYPES = [_P] * 7 + [_I, _I, ctypes.c_float, _I, _P]
_MAX_D = 2048


def reference_residual_layernorm(x, r, scale, bias, *, mask=None,
                                 eps: float = 1e-5):
    """f32 compute, outputs cast to x's dtype (h from the f32 y)."""
    r32 = r.float()
    if mask is not None:
        r32 = r32 * mask.float()
    y = x.float() + r32
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    h = (y - mu) * torch.rsqrt(var + eps)
    h = h * scale.float() + bias.float()
    return y.to(x.dtype), h.to(x.dtype)


def _launch(x2, r2, m2, scale, bias, eps: float):
    what = "fused_residual_layernorm"
    if x2.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x2.device}")
    n, d = x2.shape
    if x2.dtype not in _DTYPE_CODES or r2.dtype != x2.dtype:
        raise TypeError(f"{what}: x and r must share float32 or bfloat16, got "
                        f"{x2.dtype}/{r2.dtype}")
    if r2.shape != (n, d) or m2.shape != (n, 1) or m2.dtype != torch.float32:
        raise ValueError(f"{what}: r {tuple(r2.shape)} must be ({n}, {d}) and "
                         f"the mask float32 ({n}, 1), got {tuple(m2.shape)}")
    if d > _MAX_D or scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"{what}: D={d} must be <= {_MAX_D} with ({d},) "
                         "scale and bias")
    scale32, bias32 = scale.float().contiguous(), bias.float().contiguous()
    m1 = m2.contiguous()
    for t in (x2, r2, m1, scale32, bias32):
        if t.device != x2.device:
            raise ValueError(f"{what}: all inputs must be on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: x and r must be contiguous")
    y = torch.empty_like(x2)
    h = torch.empty_like(x2)
    fn = build.function("residual_layernorm", "dl4j_residual_layernorm",
                        _ARGTYPES)
    rc = fn(x2.data_ptr(), r2.data_ptr(), m1.data_ptr(), scale32.data_ptr(),
            bias32.data_ptr(), y.data_ptr(), h.data_ptr(), n, d, eps,
            _DTYPE_CODES[x2.dtype],
            torch.cuda.current_stream(x2.device).cuda_stream)
    build.check("residual_layernorm", rc, what)
    return y, h


def residual_layernorm_fwd(x2, r2, m2, scale, bias, eps: float = 1e-5):
    """``(y, h)`` of (N, D) rows with an (N, 1) f32 keep-mask: the kernel
    for CUDA tensors (counted), the plain version for CPU tensors."""
    if x2.device.type == "cpu":
        return reference_residual_layernorm(x2, r2, scale, bias, mask=m2,
                                            eps=eps)
    if is_fake(x2):
        # a cost count (``observability.cost``): flops, bytes, no launch
        n, d = x2.shape
        kernel_work(9 * n * d, 4 * n * d * x2.element_size() + n * 4 + d * 8)
        return torch.empty_like(x2), torch.empty_like(x2)
    y, h = _launch(x2, r2, m2, scale, bias, eps)
    fused_residual_layernorm.launches += 1
    return y, h


class _ResidualLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, r2, m2, scale, bias, eps):
        y, h = residual_layernorm_fwd(x2, r2, m2, scale, bias, eps)
        ctx.save_for_backward(y, r2, m2, scale)
        ctx.eps = eps
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        y, r2, m2, scale = ctx.saved_tensors
        with trace.span("kernel.layernorm.backward", device=y):
            y32 = y.float()
            mu = y32.mean(-1, keepdim=True)
            var = y32.var(-1, keepdim=True, correction=0)
            rstd = torch.rsqrt(var + ctx.eps)
            yhat = (y32 - mu) * rstd
            dh32 = dh.float()
            dscale = (dh32 * yhat).sum(0).to(scale.dtype)
            dbias = dh32.sum(0).to(scale.dtype)
            dyhat = dh32 * scale.float()
            g_ln = rstd * (dyhat - dyhat.mean(-1, keepdim=True)
                           - yhat * (dyhat * yhat).mean(-1, keepdim=True))
            g = dy.float() + g_ln
            dm = ((g * r2.float()).sum(-1, keepdim=True)
                  if ctx.needs_input_grad[2] else None)
            return (g.to(y.dtype), (g * m2).to(r2.dtype), dm, dscale, dbias,
                    None)


def fused_residual_layernorm(x, r, scale, bias, *, mask=None,
                             eps: float = 1e-5, block_rows: int = 256,
                             interpret: bool | None = None):
    """Fused ``y = x + r*mask; h = LN(y)`` on (..., D) activations; returns
    ``(y, h)`` in x's dtype.  ``mask`` (broadcastable to x's row shape) is
    a pre-scaled dropout keep-mask; None means no masking.
    ``block_rows`` and ``interpret`` are the reference's Pallas knobs,
    accepted and ignored (the kernel picks its rows a block from the
    width; a CPU tensor takes the plain version)."""
    d = x.shape[-1]
    n = x.numel() // d
    x2, r2 = x.reshape(n, d), r.reshape(n, d)
    if mask is None:
        m2 = torch.ones((n, 1), dtype=torch.float32, device=x.device)
    else:
        m2 = mask.float().reshape(n, -1)[:, :1].expand(n, 1)
    y, h = _ResidualLayerNorm.apply(x2, r2, m2, scale, bias, eps)
    return y.reshape(x.shape), h.reshape(x.shape)


fused_residual_layernorm.launches = 0


def _unfused(x, r, scale, bias, *, mask=None, eps: float = 1e-5, **_):
    """The torch incumbent: the transformer's two-op seam (residual add in
    x's dtype, then the f32 LN)."""
    r = r * mask.to(r.dtype) if mask is not None else r
    y = x + r.to(x.dtype)
    y32 = y.float()
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    h = (y32 - mu) * torch.rsqrt(var + eps)
    h = h * scale.float() + bias.float()
    return y, h.to(x.dtype)


registry.register(registry.KernelCandidate(
    kind="layernorm_residual", name="fused", fn=fused_residual_layernorm,
    reference=reference_residual_layernorm,
    blocks=({},),              # one row a warp: nothing to sweep
    # fwd/bwd max abs error vs the f32 reference, the JAX package's gate
    tolerances={"max_err": 1e-3},
))

registry.register(registry.KernelCandidate(
    kind="layernorm_residual", name="unfused", fn=_unfused,
    reference=reference_residual_layernorm, source="torch",
))
