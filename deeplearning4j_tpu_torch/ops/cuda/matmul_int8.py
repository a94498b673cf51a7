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
import functools
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ...device import sm_count
from ...observability.cost import kernel_work
from . import build, registry

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
#: dl4j_int8_matmul(x, dtype, q, scale, out, M, K, N, block_n, row_tile,
#:                  cluster, k_chunk, stream)
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


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


#: the kernel's shape limits (csrc/int8_matmul.cu): the largest cluster,
#: the most threads across a row, the x floats a block stages a tile
_MAX_CLUSTER, _MAX_TPR, _TILE_FLOATS = 8, 8, 4096
#: the least K-rows a cluster rank is given
_MIN_RANK_ROWS = 32


class Plan(NamedTuple):
    """One launch of ``csrc/int8_matmul.cu``: the grid is (cluster,
    ceil(N / block_n), ceil(M / row_tile)), the cluster (cluster, 1, 1)."""

    block_n: int     # output columns a block owns
    row_tile: int    # rows of x a block owns: 1, 4 or 8
    cluster: int     # blocks of a cluster, each one chunk of K
    k_chunk: int     # K-rows a cluster rank reduces

    @property
    def vec(self) -> int:
        return _vec(self.row_tile)


def _vec(row_tile: int) -> int:
    """Columns a thread owns (one 16- or 8-byte load a K-row): 16 at one
    row, 8 above, which keeps row_tile x 8 f32 accumulators in registers."""
    return 16 if row_tile == 1 else 8


@functools.lru_cache(maxsize=1024)   # the decode path asks for six shapes
def _plan(M: int, K: int, N: int, sm_count: int) -> Plan:
    """The launch plan of ``int8_matmul`` at (M, K) x (K, N).

    A call is a chain of latencies (launch, one round trip for the
    weights, the reductions), so fewer, fuller blocks win over many thin
    ones: the plan aims at about two thirds of a block a SM (measured on
    an H100 over the flagship's shapes, ``PERF.md``).  At one row of x a
    lane reduces 16 accumulators, less than a cluster merge costs (~1
    us), so the column tile narrows (down to 2 threads across) until the
    tiles alone reach that.  Otherwise the column tile is the widest
    whose tiles, split K-wise over a cluster of up to 8, reach it; then
    the smallest cluster that does, with at least ``_MIN_RANK_ROWS``
    K-rows a rank.  A block whose chunk is larger than one x tile loops
    over tiles."""
    row_tile = 1 if M <= 1 else 4 if M <= 4 else 8
    vec = _vec(row_tile)
    m_tiles = max(1, -(-M // row_tile))
    target = max(1, 2 * sm_count // 3)

    def tiles(block_n: int) -> int:
        return m_tiles * -(-N // block_n)

    if row_tile == 1:
        block_n = vec * _MAX_TPR
        while block_n > 2 * vec and tiles(block_n) < target:
            block_n //= 2
        if tiles(block_n) >= target:
            return Plan(block_n, row_tile, 1, K)
    block_n = vec * _MAX_TPR
    while block_n > 2 * vec and tiles(block_n) * _MAX_CLUSTER < target:
        block_n //= 2
    cluster = max(1, min(_MAX_CLUSTER, -(-target // max(1, tiles(block_n))),
                         K // _MIN_RANK_ROWS))
    k_chunk = -(-K // cluster)
    # no empty rank: as many ranks as chunks of k_chunk rows
    cluster = max(1, -(-K // k_chunk)) if k_chunk else 1
    return Plan(block_n, row_tile, cluster, k_chunk)


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
    plan = _plan(M, K, N, sm_count(x.device))
    fn = build.function("int8_matmul", "dl4j_int8_matmul", _ARGTYPES)
    rc = fn(x2.data_ptr(), _DTYPE_CODES[x.dtype], q.data_ptr(),
            scale.data_ptr(), out.data_ptr(), M, K, N, *plan,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check("int8_matmul", rc, "int8_matmul")
    int8_matmul.launches += 1
    return out.reshape(*lead, N)


def _counted(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The fake branch (a cost count, ``observability.cost``): the
    kernel's flops and bytes, an empty output, no launch."""
    K, N = q.shape
    M = x.numel() // K
    kernel_work(2 * M * K * N,
                M * K * x.element_size() + K * N + N * 4 + M * N * 4)
    return x.new_empty((*x.shape[:-1], N), dtype=torch.float32)


class _Int8Matmul(torch.autograd.Function):
    """Differentiable in ``x`` only, as the JAX kernel's ``custom_vjp``:
    the int8 weights are frozen serving artifacts and get no gradient."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        if x.device.type == "cpu":
            return reference_int8_matmul(x, QuantizedLinear(q, scale))
        if is_fake(x):
            return _counted(x, q)
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
