"""Blocked cross-entropy: (N, V) logits streamed tile by tile, never stored.

Port of ``deeplearning4j_tpu/ops/pallas/xent.py``.  The LM loss is the
biggest activation of big-vocab training (the f32 logits are 4.3 GB at
batch 64 x 512 x 32k vocab); the forward kernel (``csrc/blocked_xent.cu``)
streams vocabulary tiles of ``h @ head`` through a running softmax and
writes only the per-token ``w * (lse - gold)`` and ``lse``.

- :func:`reference_xent_sum` is the naive ground truth (full f32 logits),
  :func:`reference_xent_rows` the kernel's plain version (per-token
  ``(wloss, lse)``, the CPU path).
- :func:`blocked_cross_entropy` is the differentiable wrapper: a
  ``torch.autograd.Function`` whose forward is the kernel (counted in
  ``blocked_cross_entropy.launches``) and whose backward is the JAX
  package's ``_blocked_bwd`` in torch ops: a loop over token tiles that
  recomputes each tile's logits from the saved lse, with the gold-column
  term added to dhead through an accumulating ``index_put_`` (repeated
  targets summed in token order, so the step repeats bitwise on the GPU);
  targets get no gradient.
  Any N, D and V work: the kernel masks the ragged edges itself.  The
  bf16 kernel reads h and head through TMA maps, whose row strides are
  multiples of 16 bytes: h with D % 8 != 0 is copied with D padded by
  zero columns, and the head by zero rows (``_pad_d``); the tied head
  ``tok_embed.T`` (a K-major view) and a row-major (D, V) head with
  V % 8 == 0 go in as they are; any other head is copied, its columns
  padded with zeros to a multiple of 8 (the kernel masks them by the
  real V).  On a CUDA tensor the kernel runs or
  the call raises.
- :func:`_scan_xent_sum` is the torch incumbent: checkpointed token tiles
  whose logits do materialize.
"""

from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.checkpoint import checkpoint

from ...device import sm_count
from ...observability import tracing as trace
from ...observability.cost import kernel_work
from . import build, registry

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: dl4j_blocked_xent(h, head, targets, weights, wloss, lse, part, N, V, D,
#: sd, sv, e_kmajor, n_splits, dtype, stream)
_ARGTYPES = [_P] * 7 + [_I] * 3 + [_L, _L] + [_I] * 3 + [_P]
_BT, _BV = 128, 128          # the kernels' token and vocabulary tiles


def _logits_f32(h, head):
    """``h @ head`` with f32 output; bf16 operands are exact in f32, so
    this is JAX's ``dot(..., preferred_element_type=f32)``."""
    return h.float() @ head.float()


def reference_xent_sum(h, head, targets, weights=None):
    """Naive ground truth: full (N, V) f32 logits, weighted sum of
    per-token (lse - gold)."""
    wloss, _ = reference_xent_rows(h, head, targets, weights)
    return wloss.sum()


def reference_xent_rows(h, head, targets, weights=None):
    """The kernel's plain version: ``(w * (lse - gold), lse)``, both (N,)
    f32, from the full f32 logits of ``h`` (N, D) against ``head`` (D, V)."""
    logits = _logits_f32(h, head)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, targets.long()[:, None])[:, 0]
    w = torch.ones_like(lse) if weights is None else weights.float()
    return w * (lse - gold), lse


def _splits(device, n_tok: int, n_vt: int) -> int:
    """Vocabulary splits: as many as keep every token tile's blocks within
    one block a SM (a bf16 block fills its SM), no empty split."""
    tiles = -(-n_tok // _BT)
    want = max(1, sm_count(device) // tiles)
    per = -(-n_vt // min(n_vt, want))
    return -(-n_vt // per)


def _tma_head(head):
    """``(head, kmajor)`` for the bf16 kernel's TMA map of ``head`` (D, V):
    the view itself where it is K-major (``sd == 1``) or row-major with
    16-byte rows, else a row-major copy padded to V % 8 == 0."""
    sd, sv = head.stride()
    aligned = head.data_ptr() % 16 == 0
    if sd == 1 and sv % 8 == 0 and aligned:
        return head, True
    if sv == 1 and sd % 8 == 0 and aligned:
        return head, False
    d, v = head.shape
    padded = torch.zeros((d, -(-v // 8) * 8), dtype=head.dtype,
                         device=head.device)
    padded[:, :v] = head
    return padded, False


def _pad_d(h, head):
    """``(h, head)`` with D padded to a multiple of 8 by zero columns of
    ``h`` and zero rows of ``head``, for the bf16 kernel's TMA maps (rows
    of 16 bytes): the added products are zero, so the logits are exact."""
    n, d = h.shape
    d8 = -(-d // 8) * 8
    hp = torch.zeros((n, d8), dtype=h.dtype, device=h.device)
    hp[:, :d] = h
    headp = torch.zeros((d8, head.shape[1]), dtype=head.dtype,
                        device=head.device)
    headp[:d] = head
    return hp, headp


def _launch(h, head, targets, weights, n_splits=None):
    what = "blocked_cross_entropy"
    if h.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {h.device}")
    if h.dim() != 2 or head.dim() != 2 or head.shape[0] != h.shape[1]:
        raise ValueError(f"{what}: h {tuple(h.shape)} must be (N,D) and head "
                         f"(D,V), got {tuple(head.shape)}")
    n, d = h.shape
    v = head.shape[1]
    if h.dtype not in _DTYPE_CODES or head.dtype != h.dtype:
        raise TypeError(f"{what}: h and head must share float32 or bfloat16, "
                        f"got {h.dtype}/{head.dtype}")
    if targets.dtype != torch.int32 or targets.shape != (n,) \
            or weights.dtype != torch.float32 or weights.shape != (n,):
        raise TypeError(f"{what}: targets must be int32 ({n},) and weights "
                        f"float32 ({n},)")
    for t in (head, targets, weights):
        if t.device != h.device:
            raise ValueError(f"{what}: all inputs must be on {h.device}")
    if not (h.is_contiguous() and targets.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError(f"{what}: h, targets and weights must be contiguous")
    if h.dtype == torch.bfloat16 and (d % 8 or h.data_ptr() % 16):
        h, head = _pad_d(h, head)
        d = h.shape[1]
    kmajor = False
    if h.dtype == torch.bfloat16:
        head, kmajor = _tma_head(head)
    sd, sv = head.stride()
    # n_splits: the vocabulary splits (by default _splits'); chip_smoke.py
    # times another count against the default
    n_splits = n_splits or _splits(h.device, n, -(-v // _BV))
    wloss = torch.empty((n,), dtype=torch.float32, device=h.device)
    lse = torch.empty_like(wloss)
    part = torch.empty((n_splits, n, 3), dtype=torch.float32, device=h.device)
    fn = build.function("blocked_xent", "dl4j_blocked_xent", _ARGTYPES)
    rc = fn(h.data_ptr(), head.data_ptr(), targets.data_ptr(),
            weights.data_ptr(), wloss.data_ptr(), lse.data_ptr(),
            part.data_ptr(), n, v, d, sd, sv, int(kmajor), n_splits,
            _DTYPE_CODES[h.dtype],
            torch.cuda.current_stream(h.device).cuda_stream)
    build.check("blocked_xent", rc, what)
    return wloss, lse


def xent_fwd(h, head, targets, weights):
    """``(wloss, lse)`` per token: the kernel for CUDA tensors (counted),
    the plain version for CPU tensors.  ``targets`` int32, ``weights``
    f32, both (N,)."""
    if h.device.type == "cpu":
        return reference_xent_rows(h, head, targets, weights)
    if is_fake(h):
        # a cost count (``observability.cost``): flops, bytes, no launch
        (n, d), v = h.shape, head.shape[1]
        kernel_work(2 * n * v * d, (n * d + d * v) * h.element_size()
                    + n * 16)
        wloss = h.new_empty((n,), dtype=torch.float32)
        return wloss, torch.empty_like(wloss)
    out = _launch(h, head, targets, weights)
    blocked_cross_entropy.launches += 1
    return out


def _blocked_bwd(h2, head, t2, w2, lse, gct, block_t: int):
    """Gradients of ``sum(w * (lse - gold))``: a loop over token tiles,
    each recomputing its (tile, V) logits from the saved lse."""
    head32 = head.float()
    # dhead accumulates transposed, (V, D): the gold term is then a
    # row-wise index_put_ with accumulate, which sums repeated targets in
    # token order on the GPU too (index_add_ there adds by atomics, in an
    # order that changes from run to run)
    dhead_t = torch.zeros(head.shape[::-1], dtype=torch.float32,
                          device=head.device)
    dh = torch.empty_like(h2)
    dw = torch.empty_like(w2)
    for i in range(0, h2.shape[0], block_t):
        h_t, t_t = h2[i:i + block_t], t2[i:i + block_t].long()
        lse_t = lse[i:i + block_t]
        logits = _logits_f32(h_t, head)
        p = torch.exp(logits - lse_t[:, None])
        gw = (gct * w2[i:i + block_t])[:, None]
        # dL/dlogits = g*w * (softmax - onehot), the onehot never built:
        # a product with p, then the gold columns on their own
        gwp = gw * p
        dh[i:i + block_t] = (gwp @ head32.T - gw * head32.T[t_t]).to(h2.dtype)
        h32 = h_t.float()
        dhead_t += gwp.T @ h32
        dhead_t.index_put_((t_t,), -(gw * h32), accumulate=True)
        gold = logits.gather(1, t_t[:, None])[:, 0]
        dw[i:i + block_t] = gct * (lse_t - gold)
    return dh, dhead_t.T.to(head.dtype), dw


class _BlockedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, head, t2, w2, block_t):
        with trace.span("kernel.xent.forward", device=h2,
                        shape=tuple(h2.shape), vocab=head.shape[1],
                        dtype=str(h2.dtype)[6:]):
            wloss, lse = xent_fwd(h2, head, t2, w2)
        ctx.save_for_backward(h2, head, t2, w2, lse)
        ctx.block_t = block_t
        return wloss.sum()

    @staticmethod
    def backward(ctx, gct):
        h2, head, t2, w2, lse = ctx.saved_tensors
        with trace.span("kernel.xent.backward", device=h2):
            dh, dhead, dw = _blocked_bwd(h2, head, t2, w2, lse, gct,
                                         ctx.block_t)
        return dh, dhead, None, dw if ctx.needs_input_grad[3] else None, None


def blocked_cross_entropy(h, head, targets, weights=None, *,
                          block_t: int = 256, block_v: int = 512,
                          interpret: bool | None = None):
    """Weighted token cross-entropy SUM of (N, D) hiddens against a (D, V)
    head, streamed so the (N, V) logits never exist (the caller divides
    by the token count).  ``block_t`` is the backward's token tile; the
    CUDA kernels' tiles are fixed (128 tokens x 128 columns), so
    ``block_v`` and ``interpret``, the reference's Pallas knobs, are
    accepted and ignored."""
    n = h.shape[0]
    t2 = targets.to(torch.int32).contiguous()
    w2 = (torch.ones((n,), dtype=torch.float32, device=h.device)
          if weights is None else weights.float().contiguous())
    return _BlockedXent.apply(h, head, t2, w2, min(block_t, n))


blocked_cross_entropy.launches = 0


def _scan_xent_sum(h, head, targets, weights=None, *, block_t: int = 256,
                   **_):
    """The torch incumbent: checkpointed token tiles of the naive loss, so
    each tile's logits materialize but are not stored for the backward."""
    n = h.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=h.device)
         if weights is None else weights.float())
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, n, block_t):
        total = total + checkpoint(
            reference_xent_sum, h[i:i + block_t], head, targets[i:i + block_t],
            w[i:i + block_t], use_reentrant=False)
    return total


registry.register(registry.KernelCandidate(
    kind="xent", name="blocked", fn=blocked_cross_entropy,
    reference=reference_xent_sum,
    blocks=({"block_t": 128}, {"block_t": 256}, {"block_t": 512}),
    # fwd relative loss error + bwd max grad error vs reference (f32)
    tolerances={"max_err": 1e-3},
))

registry.register(registry.KernelCandidate(
    kind="xent", name="scan", fn=_scan_xent_sum,
    reference=reference_xent_sum, source="torch",
))
