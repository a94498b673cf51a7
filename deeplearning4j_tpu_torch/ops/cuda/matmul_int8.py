"""Weight-quantized int8 matmul for the serving decode path.

Port of ``deeplearning4j_tpu/ops/pallas/matmul_int8.py``.  Decode streams
every weight matrix once per token for a handful of activation rows, so
storing the big matrices (FFN w1/w2 and the LM head) as int8 with
per-output-channel scales cuts that traffic 4x against f32.

Quantization is symmetric absmax per output channel: ``scale[n] =
max(|w[:, n]|) / 127``, ``q = round(w / scale)`` — bitwise the JAX
package's (both round half to even).  Activations stay in the model's
compute dtype (weight-only quantization).

:func:`int8_matmul` is the kernel wrapper: on a CUDA tensor it launches
``csrc/int8_matmul.cu`` (and counts the launch in
``int8_matmul.launches``); on a CPU tensor it computes the plain version,
:func:`reference_int8_matmul`.  The wrapper never falls back from the
kernel to the plain version.  It is a ``torch.autograd.Function``
differentiable in ``x`` (the JAX package's ``_int8_mm_bwd``: ``dx = (g ·
scale) @ q^T`` in x's dtype, no gradient for the frozen int8 weights), on
the card as on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...device import sm_count
from . import build, registry

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
#: dl4j_int8_matmul(x, dtype, q, scale, out, part, M, K, N, k_splits, stream)
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]


class QuantizedLinear(NamedTuple):
    """Per-output-channel int8 weight: ``w ≈ q * scale``."""

    q: torch.Tensor       # (K, N) int8
    scale: torch.Tensor   # (N,) f32


def quantize(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric absmax quantization of a (K, N) matrix, per column."""
    w32 = w.to(torch.float32)
    amax = torch.amax(torch.abs(w32), dim=0)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedLinear(q=q, scale=scale)


def dequantize(qw: QuantizedLinear) -> torch.Tensor:
    return qw.q.to(torch.float32) * qw.scale


def reference_int8_matmul(x: torch.Tensor, qw: QuantizedLinear,
                          **_) -> torch.Tensor:
    """The plain version: dequantize, then an f32 matmul; f32 out."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    return (x2 @ dequantize(qw)).reshape(*lead, qw.q.shape[1])


#: column tile of the kernel (csrc/int8_matmul.cu: kBlockN) and the least
#: K rows a split is worth (one shared-memory tile of x)
_BLOCK_N, _MIN_SPLIT_K = 32, 256


def _k_splits(device, K: int, N: int) -> int:
    """Splits of K so that column blocks x splits give every SM about
    two blocks."""
    col_blocks = -(-N // _BLOCK_N)
    return max(1, min(-(-2 * sm_count(device) // col_blocks),
                      K // _MIN_SPLIT_K))


def _launch(x: torch.Tensor, q: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor (counted in ``int8_matmul.launches``)."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_matmul: x dtype {x.dtype} not in "
                        f"{list(_DTYPE_CODES)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("int8_matmul: q must be int8 and scale float32, got "
                        f"{q.dtype}/{scale.dtype}")
    if q.dim() != 2 or scale.shape != (q.shape[1],) or x.shape[-1] != q.shape[0]:
        raise ValueError(f"int8_matmul: shapes x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, scale {tuple(scale.shape)}")
    if q.device != x.device or scale.device != x.device:
        raise ValueError("int8_matmul: x, q and scale must share a device")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul: q and scale must be contiguous")
    K, N = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    k_splits = _k_splits(x.device, K, N)
    part = (torch.empty((k_splits, M, N), dtype=torch.float32,
                        device=x.device) if k_splits > 1 else out)
    fn = build.function("int8_matmul", "dl4j_int8_matmul", _ARGTYPES)
    rc = fn(x2.data_ptr(), _DTYPE_CODES[x.dtype], q.data_ptr(),
            scale.data_ptr(), out.data_ptr(), part.data_ptr(), M, K, N,
            k_splits, torch.cuda.current_stream(x.device).cuda_stream)
    build.check("int8_matmul", rc, "int8_matmul")
    int8_matmul.launches += 1
    return out.reshape(*lead, N)


class _Int8Matmul(torch.autograd.Function):
    """Differentiable in ``x`` only, as the JAX kernel's ``custom_vjp``:
    the int8 weights are frozen serving artifacts and get no gradient."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        if x.device.type == "cpu":
            return reference_int8_matmul(x, QuantizedLinear(q, scale))
        return _launch(x, q, scale)

    @staticmethod
    def backward(ctx, g):
        # the JAX package's _int8_mm_bwd: fold the scale into g, then
        # g @ q^T, cast to x's dtype (a plain matmul outside the kernel)
        q, scale = ctx.saved_tensors
        dx = (g.float() * scale) @ q.float().T
        return dx.to(ctx.x_dtype), None, None


def int8_matmul(x: torch.Tensor, qw: QuantizedLinear) -> torch.Tensor:
    """``x @ (q * scale)`` on (..., K) activations, f32 out (callers
    cast); differentiable with respect to ``x``.  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    return _Int8Matmul.apply(x, qw.q, qw.scale)


int8_matmul.launches = 0


def quantize_params_for_decode(params: dict, cfg) -> dict:
    """Serving-side tree transform: add int8 copies of the decode path's
    bandwidth-heavy matrices (FFN w1/w2 per layer + the LM head) and drop
    the float FFN originals from the copy.  ``_ffn``/``_decode_attend``
    take the int8 path purely on key presence (``w1_q``, ``head_q``)."""
    layers = []
    for lp in params["layers"]:
        lp2 = {k: v for k, v in lp.items() if k not in ("w1", "w2")}
        lp2["w1_q"] = quantize(lp["w1"])
        lp2["w2_q"] = quantize(lp["w2"])
        layers.append(lp2)
    head = (params["tok_embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    return dict(params, layers=layers, head_q=quantize(head.contiguous()))


def top1_agreement(logits_a: torch.Tensor, logits_b: torch.Tensor) -> float:
    """Fraction of rows whose argmax agrees — the int8 adoption gate's
    statistic (token-level greedy agreement)."""
    return (torch.argmax(logits_a, dim=-1) == torch.argmax(logits_b, dim=-1)
            ).to(torch.float32).mean().item()


registry.register(registry.KernelCandidate(
    kind="int8_matmul", name="cuda_int8", fn=int8_matmul,
    reference=reference_int8_matmul,
    # vs the plain version the kernel must be near-exact; adoption on the
    # serving path additionally needs token-level greedy agreement
    tolerances={"max_err": 1e-3, "min": {"top1_agree": 0.999}},
))

registry.register(registry.KernelCandidate(
    kind="int8_matmul", name="f32", fn=reference_int8_matmul,
    reference=reference_int8_matmul, source="torch",
))
