"""Flash and fused attention for training: the forward as a CUDA kernel.

Port of ``deeplearning4j_tpu/ops/flash_attention.py`` (``flash_attention``)
and ``deeplearning4j_tpu/ops/pallas/attention.py`` (``fused_attention``,
``reference_attention`` and the single-shard ``ring`` incumbent).  Both
TPU kernels run the flash-v2 forward and return the output and the row
log-sum-exp; ``fused`` stops the key loop at the causal frontier where
``flash`` streams every key block and masks.  Here one CUDA template
(``csrc/flash_attention.cu``) serves both, with a frontier flag.

- :func:`reference_flash_fwd` is the kernel's plain version, ``(out,
  lse)`` computed in f32; the CPU path and the tests use it.
- :func:`flash_attention` / :func:`fused_attention` take ``(B, T, H, Dh)``
  tensors, as the JAX functions do, and are differentiable through a
  ``torch.autograd.Function``: its forward is the kernel (the plain
  version for CPU tensors) and its backward is :func:`_blockwise_bwd`,
  the JAX package's jnp recompute written in torch ops (a loop over key
  blocks rebuilding P from ``lse``).  The JAX package has no backward
  kernel, so neither has the port.
- Each wrapper counts its kernel launches in ``<wrapper>.launches``.  On a
  CUDA tensor the kernel runs or the call raises: there is no fallback.

The kernel reads q, k and v through their strides (last dim contiguous),
so the q/k/v views of the packed projection go in without a copy; in bf16
it loads them by TMA as (Dh, H, T, B) maps, whose strides and base must be
multiples of 16 bytes (checked here).  Its tiles are fixed (bf16: 128
query rows by 128 keys; f32: 64 by 64); ``block_k`` sets the backward's
key-block size, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from ...observability import tracing as trace
from ...observability.cost import kernel_work
from . import build, registry

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: dl4j_flash_attention(q, k, v, out, lse, B, T, H, Dh, 9 strides, causal,
#: frontier, scale, dtype, stream)
_ARGTYPES = [_P] * 5 + [_I] * 4 + [_L] * 9 + [_I, _I, ctypes.c_float, _I, _P]
_NEG_INF = -1e30


def reference_attention(q, k, v, *, causal: bool = True):
    """Naive softmax attention on (B, T, H, Dh): the ground truth every
    attention candidate is held to (f32 scores, P cast to v's dtype)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def _causal_keep(t_q: int, t_k: int, k0: int, device) -> torch.Tensor:
    """(t_q, t_k) bool: query row i may see key k0 + j."""
    return (torch.arange(t_q, device=device)[:, None]
            >= k0 + torch.arange(t_k, device=device)[None, :])


def reference_flash_fwd(q, k, v, causal: bool):
    """The kernel's plain version: ``(out (B,T,H,Dh) in q's dtype, lse
    (B,H,T) f32)`` with f32 scores, masked scores at -1e30, as the Pallas
    kernels compute them."""
    T, Dh = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * Dh ** -0.5, k.float())
    if causal:
        s = torch.where(_causal_keep(T, T, 0, q.device), s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp_min(p.sum(-1), 1e-30)                  # (B,H,T)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / l_safe.transpose(1, 2)[..., None]
    return out.to(q.dtype), m[..., 0] + torch.log(l_safe)


def _blockwise_bwd(q, k, v, out, lse, do, causal: bool, block_k: int = 128):
    """O(T)-memory backward of flash attention: rebuild P per key block
    from (q, lse), accumulate dq and emit each block's dk/dv (the JAX
    package's ``_blockwise_bwd``, f32 throughout, in torch ops)."""
    T, Dh = q.shape[1], q.shape[-1]
    bk = min(block_k, T)
    scale = Dh ** -0.5

    def bhtd(x):
        return x.float().permute(0, 2, 1, 3)                    # (B,H,T,Dh)

    qf, kf, vf, dof = bhtd(q) * scale, bhtd(k), bhtd(v), bhtd(do)
    delta = (dof * bhtd(out)).sum(-1)                           # (B,H,T)
    dq = torch.zeros_like(qf)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for k0 in range(0, T, bk):
        k_j, v_j = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = qf @ k_j.transpose(-1, -2)                          # (B,H,T,bk)
        if causal:
            s = torch.where(_causal_keep(T, k_j.shape[2], k0, q.device), s,
                            _NEG_INF)
        p = torch.exp(s - lse[..., None])
        dv[:, :, k0:k0 + bk] = p.transpose(-1, -2) @ dof
        dp = dof @ v_j.transpose(-1, -2)
        ds = p * (dp - delta[..., None])
        dq += (ds @ k_j) * scale
        dk[:, :, k0:k0 + bk] = ds.transpose(-1, -2) @ qf

    def back(g, like):
        return g.permute(0, 2, 1, 3).to(like.dtype)

    return back(dq, q), back(dk, k), back(dv, v)


def _launch(q, k, v, causal: bool, frontier: bool):
    what = "fused_attention" if frontier else "flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one (B,T,H,Dh) shape, got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must be one of float32/bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, T, H, Dh = q.shape
    if Dh not in (32, 64, 128):
        raise ValueError(f"{what}: head width {Dh} not in (32, 64, 128)")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{what}: all inputs must be on {q.device}")
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: rows must be contiguous and 16-byte "
                             f"aligned (strides {t.stride()})")
    out = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    fn = build.function("flash_attention", "dl4j_flash_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, T, H, Dh, *strides, int(causal), int(frontier),
            Dh ** -0.5, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", rc, what)
    return out, lse


def _counted(q, causal: bool):
    """The fake branch (a cost count, ``observability.cost``): the
    forward's flops over the (query, key) pairs it needs and its bytes, an
    empty output, no launch."""
    B, T, H, Dh = q.shape
    pairs = T * (T + 1) // 2 if causal else T * T
    kernel_work(4 * B * H * Dh * pairs,
                4 * B * T * H * Dh * q.element_size() + B * H * T * 4)
    return (q.new_empty((B, T, H, Dh)),
            q.new_empty((B, H, T), dtype=torch.float32))


def attention_fwd(q, k, v, *, causal: bool, frontier: bool):
    """``(out, lse)`` of the forward: the kernel for CUDA tensors (counted
    on ``fused_attention.launches`` when ``frontier`` else on
    ``flash_attention.launches``), the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return reference_flash_fwd(q, k, v, causal)
    if is_fake(q):
        return _counted(q, causal)
    out, lse = _launch(q, k, v, causal, frontier)
    (fused_attention if frontier else flash_attention).launches += 1
    return out, lse


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, frontier, block_k):
        with trace.span("kernel.attention.forward", device=q,
                        shape=tuple(q.shape), dtype=str(q.dtype)[6:],
                        causal=causal):
            out, lse = attention_fwd(q, k, v, causal=causal,
                                     frontier=frontier)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block_k = causal, block_k
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        with trace.span("kernel.attention.backward", device=do):
            dq, dk, dv = _blockwise_bwd(q, k, v, out, lse, do, ctx.causal,
                                        ctx.block_k)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128, interpret: bool | None = None):
    """Flash attention on (B, T, H, Dh) tensors, every key block streamed
    and masked; differentiable.  Same contract as
    :func:`reference_attention` within the registered tolerance.
    ``block_q`` and ``interpret`` are the reference's Pallas knobs,
    accepted and ignored: the CUDA kernel's query tile is fixed, and a
    CPU tensor takes the plain version."""
    return _Attention.apply(q, k, v, causal, False, block_k)


def fused_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128, interpret: bool | None = None):
    """As :func:`flash_attention`, but under ``causal`` each query tile's
    key loop stops at the causal frontier."""
    return _Attention.apply(q, k, v, causal, True, block_k)


flash_attention.launches = 0
fused_attention.launches = 0


def _ring_single_shard(q, k, v, *, causal: bool = True, **_):
    """The torch incumbent as a candidate: single-shard ring attention
    (imported at call time: models must not load with the registry)."""
    from ...models.transformer import ring_attention
    return ring_attention(q, k, v, n_sp=1, sp_axis=None, causal=causal,
                          t_local=q.shape[1])


registry.register(registry.KernelCandidate(
    kind="attention", name="flash", fn=flash_attention,
    reference=reference_attention,
    blocks=({},),              # fixed tiles: nothing to sweep
    # fwd/bwd max abs error vs naive attention, the JAX package's gate
    tolerances={"max_err": 0.05},
))

registry.register(registry.KernelCandidate(
    kind="attention", name="fused", fn=fused_attention,
    reference=reference_attention,
    blocks=({},),
    tolerances={"max_err": 0.05},
))

registry.register(registry.KernelCandidate(
    kind="attention", name="ring", fn=_ring_single_shard,
    reference=reference_attention, source="torch",
))
