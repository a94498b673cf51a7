"""Transformer LM — the flagship model: training and decoding on one device.

Port of ``deeplearning4j_tpu/models/transformer.py`` without its mesh:
config and parameters; the training forward (``_block`` with the ring /
flash / fused attention and the fused residual+LayerNorm seam,
``encode_local``, ``forward_local``) and losses (``lm_head_loss`` with its
full, chunked and blocked routes, ``lm_loss_local``, the classifier head);
the KV-cached ``decode_step``, the paged ``decode_step_paged`` and the
speculative verify windows ``decode_window``/``decode_window_paged``; and
``TransformerLM`` with ``build_train_step``/``build_finetune_step``,
``fit``, ``score``, ``sample`` (full forward or KV-cached) and
``beam_search``.  The parameter tree
keeps the JAX package's names and layouts (``wqkv`` ``(D, 3, H, Dh)`` or
``wq``/``wkv`` under GQA, ``wo`` ``(H, Dh, D)``, ``w1/b1/w2/b2``, tied
``tok_embed``, ``pos_embed``, ``final_ln_*``), so moving parameters
between the packages is a key-by-key numpy copy (``models.convert``).
Sequence and tensor parallel axes (``n_sp > 1``, ``tp_axis``) and a mesh
raise ``NotImplementedError``: they come with the multi-device port.

Numerics mirror the JAX package: matmuls in ``cfg.dtype``, attention
scores, softmax and LayerNorm in f32.  Caches and page pools are updated
IN PLACE where the JAX package returned new (donated) buffers; every
function that does so says so.  The train step is functional, as in JAX:
it returns new parameters and optimizer state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops import losses
from ..ops.cuda import kv_quant, registry
from ..ops.cuda.layernorm import fused_residual_layernorm
from ..ops.cuda.matmul_int8 import int8_matmul
from ..optimize import transforms as tx_mod
from ..utils.tree_math import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    max_len: int = 2048
    causal: bool = True              # False = BERT-style bidirectional
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16    # matmul compute dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True               # recompute each block in the backward
    attention: str = "ring"          # "ring" (torch incumbent) or a
    #                                  registered attention kernel
    #                                  ("flash", "fused")
    fused_ln: bool = False           # fuse the mid-block residual + LN seam
    xent_impl: str = "scan"          # "scan" (chunked, checkpointed) or
    #                                  "blocked" (the streaming kernel)
    xent_chunk: int = 2048           # LM-loss token-chunk size; 0 disables
    n_kv_heads: int | None = None    # GQA/MQA: K/V heads shared by groups
    #                                  of n_heads // n_kv_heads query heads

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model={self.d_model} is not a multiple of "
                             f"n_heads={self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        """Effective K/V head count (== n_heads without GQA)."""
        kv = self.n_kv_heads if self.n_kv_heads is not None else self.n_heads
        if not (1 <= kv <= self.n_heads and self.n_heads % kv == 0):
            raise ValueError(
                f"n_kv_heads={kv} must divide n_heads={self.n_heads}")
        return kv

    def flops_per_token(self) -> float:
        """Approximate training FLOPs per token (fwd+bwd ~ 6 * params plus
        the attention term), the MFU accounting of the JAX package."""
        n_params = (self.vocab_size * self.d_model
                    + self.n_layers * (4 * self.d_model * self.d_model
                                       + 2 * self.d_model * self.d_ff)
                    + self.max_len * self.d_model)
        attn = self.n_layers * 2 * self.max_len * self.d_model
        return 6.0 * (n_params + attn)


# --------------------------------------------------------------------------- params

def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device=None) -> dict:
    """Scaled-normal init drawn from ``gen``; qkv packed (D, 3, H, Dh),
    out proj (H, Dh, D); under GQA ``wq`` (D, H, Dh) and ``wkv``
    (D, 2, Kv, Dh).  Draws happen on ``gen``'s device, the result lands
    on ``device``.  (torch and jax give different numbers from one seed:
    parity with the JAX package goes through ``models.convert``.)"""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    kv = cfg.kv_heads

    def norm(shape, scale):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (scale * w).to(device=dev, dtype=pd)

    def const(value, n):
        return torch.full((n,), value, dtype=pd, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        if kv == h:
            qkv_leaves = {"wqkv": norm((d, 3, h, dh), d ** -0.5)}
        else:
            qkv_leaves = {"wq": norm((d, h, dh), d ** -0.5),
                          "wkv": norm((d, 2, kv, dh), d ** -0.5)}
        layers.append({
            "ln1_scale": const(1.0, d), "ln1_bias": const(0.0, d),
            **qkv_leaves,
            "wo": norm((h, dh, d), (h * dh) ** -0.5),
            "ln2_scale": const(1.0, d), "ln2_bias": const(0.0, d),
            "w1": norm((d, f), d ** -0.5),
            "b1": const(0.0, f),
            "w2": norm((f, d), f ** -0.5),
            "b2": const(0.0, d),
        })
    params = {
        "tok_embed": norm((cfg.vocab_size, d), 0.02),
        "pos_embed": norm((cfg.max_len, d), 0.02),
        "final_ln_scale": const(1.0, d),
        "final_ln_bias": const(0.0, d),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = norm((d, cfg.vocab_size), d ** -0.5)
    return params


#: matmul operands every decode step casts to ``cfg.dtype``
_MATMUL_LEAVES = ("wqkv", "wq", "wkv", "wo", "w1", "w2", "b1", "b2")


def cast_for_decode(params: dict, cfg: TransformerConfig) -> dict:
    """Serving-side copy of ``params`` whose matmul operands are already
    in ``cfg.dtype``.  Every decode op casts them to ``cfg.dtype`` first,
    so the values are exactly those of the per-step casts; the copy only
    stops each step from re-reading the f32 weights.  Embeddings and
    LayerNorm parameters stay as they are (they are used in f32)."""
    layers = [{k: (v.to(cfg.dtype) if k in _MATMUL_LEAVES else v)
               for k, v in lp.items()} for lp in params["layers"]]
    out = dict(params, layers=layers)
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"].to(cfg.dtype)
    return out


# --------------------------------------------------------------------------- math

def _layernorm(x, scale, bias, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _qkv_proj(lp, h, dt):
    """Project normed activations ``h`` (..., D) to ``(q, k, v)`` heads;
    GQA trees (``wkv`` present) give k/v with ``n_kv_heads`` heads."""
    if "wkv" in lp:
        q = torch.einsum("...d,dhe->...he", h.to(dt), lp["wq"].to(dt))
        kv = torch.einsum("...d,dshe->...she", h.to(dt), lp["wkv"].to(dt))
        return q, kv[..., 0, :, :], kv[..., 1, :, :]
    qkv = torch.einsum("...d,dshe->...she", h.to(dt), lp["wqkv"].to(dt))
    return qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]


def repeat_kv_heads(x, n_rep: int):
    """GQA head-group broadcast along axis -2: query head ``h`` reads
    shared head ``h // n_rep``; ``n_rep == 1`` returns ``x`` untouched."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


def _ffn(lp, h, dt, int8_fn=None):
    """The FFN sublayer on (..., D) activations.  A serving tree from
    ``quantize_params_for_decode`` carries ``w1_q``/``w2_q`` and runs
    through ``int8_fn`` (default: the ``int8_matmul`` kernel wrapper)."""
    if "w1_q" in lp:
        mm = int8_fn or int8_matmul
        u = mm(h.to(dt), lp["w1_q"]).to(dt)
        u = F.gelu(u + lp["b1"].to(dt), approximate="tanh")
        return mm(u, lp["w2_q"]).to(dt)
    u = torch.einsum("...d,df->...f", h.to(dt), lp["w1"].to(dt))
    u = F.gelu(u + lp["b1"].to(dt), approximate="tanh")
    return torch.einsum("...f,fd->...d", u, lp["w2"].to(dt))


# --------------------------------------------------------------------------- training forward

@dataclasses.dataclass(frozen=True)
class TrainKernels:
    """The kernel entry points the training forward calls.  ``None`` takes
    the default: the registered attention candidate named by
    ``cfg.attention``, ``fused_residual_layernorm`` and
    ``losses.blocked_token_xent``.  Another value replaces that call with
    a function of the same signature; ``chip_smoke.py`` passes the plain
    versions to hold one step through the kernels against one through
    them."""

    attention: Callable | None = None            # (q, k, v, *, causal)
    residual_layernorm: Callable | None = None   # (x, r, scale, bias)
    xent: Callable | None = None                 # (h, head, targets)


_DEFAULT_KERNELS = TrainKernels()


def _no_axes(n_sp: int = 1, sp_axis=None, tp_axis=None) -> None:
    if n_sp != 1 or sp_axis is not None:
        raise NotImplementedError("sequence parallelism (n_sp > 1) comes "
                                  "with the multi-device port")
    if tp_axis is not None:
        raise NotImplementedError("tensor parallelism (tp_axis) comes with "
                                  "the multi-device port")


def _attend_block(q, k, v, q_pos, k_pos, causal, acc, m, l):
    """One flash-style block update: q (B, Tq, H, Dh), k/v (B, Tk, H, Dh),
    acc (B, Tq, H, Dh) f32, m/l (B, Tq, H) running max / denominator."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    if causal:
        mask = q_pos[None, :, None, None] >= k_pos[None, None, None, :]
        s = s.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, s.amax(-1))
    # guard rows with no valid keys yet (all -inf)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bqhk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return acc_new, m_new, l_new


def ring_attention(q, k, v, *, n_sp: int, sp_axis, causal: bool,
                   t_local: int):
    """Blockwise ring attention, single shard: with ``n_sp == 1`` it is one
    flash-style block over the whole sequence (the torch incumbent of the
    ``attention`` kind).  ``n_sp > 1`` raises until the multi-device
    port."""
    _no_axes(n_sp, sp_axis)
    B, Tq, H, Dh = q.shape
    q_pos = torch.arange(t_local, device=q.device)
    acc = torch.zeros((B, Tq, H, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, Tq, H), float("-inf"), device=q.device)
    l = torch.zeros((B, Tq, H), device=q.device)
    acc, m, l = _attend_block(q, k, v, q_pos, q_pos, causal, acc, m, l)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype)


def _block(params, x, cfg: TransformerConfig, n_sp=1, sp_axis=None,
           tp_axis=None, t_local=None, kernels: TrainKernels | None = None):
    """One transformer block on (B, T, D) activations (no tp/sp axes)."""
    _no_axes(n_sp, sp_axis, tp_axis)
    kernels = kernels or _DEFAULT_KERNELS
    t_local = x.shape[1] if t_local is None else t_local
    dt = cfg.dtype
    h = _layernorm(x, params["ln1_scale"], params["ln1_bias"])
    q, k, v = _qkv_proj(params, h, dt)
    if k.shape[-2] != q.shape[-2]:
        # GQA head-group broadcast before attention
        k = repeat_kv_heads(k, q.shape[-2] // k.shape[-2])
        v = repeat_kv_heads(v, q.shape[-2] // v.shape[-2])
    if cfg.attention != "ring" and n_sp == 1 and t_local % 128 == 0:
        # the JAX package's routing rule: a registered attention kernel
        # takes single-shard sequences of whole 128-token blocks
        attend = (kernels.attention
                  or registry.get("attention", cfg.attention).fn)
        attn = attend(q, k, v, causal=cfg.causal)
    else:
        attn = ring_attention(q, k, v, n_sp=n_sp, sp_axis=sp_axis,
                              causal=cfg.causal, t_local=t_local)
    proj = torch.einsum("bthe,hed->btd", attn.to(dt), params["wo"].to(dt))
    if cfg.fused_ln:
        fused = kernels.residual_layernorm or fused_residual_layernorm
        x, h2 = fused(x, proj.to(x.dtype), params["ln2_scale"],
                      params["ln2_bias"])
    else:
        x = x + proj.to(x.dtype)
        h2 = _layernorm(x, params["ln2_scale"], params["ln2_bias"])
    down = _ffn(params, h2, dt) + params["b2"].to(dt)
    return x + down.to(x.dtype)


def embed_local(params, tokens, cfg: TransformerConfig, sp_axis=None):
    """Token + position embedding of (B, T) tokens, in ``cfg.dtype``."""
    _no_axes(sp_axis=sp_axis)
    T = tokens.shape[1]
    x = params["tok_embed"][tokens.long()]
    return (x + params["pos_embed"][:T][None]).to(cfg.dtype)


def _lm_head(params, cfg: TransformerConfig):
    return params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]


def lm_head_loss(params, h, targets, cfg: TransformerConfig,
                 kernels: TrainKernels | None = None):
    """Mean token cross entropy of final hidden states (B, T, D) against
    targets (tied or separate head).

    When ``cfg.xent_chunk`` divides the token count (or a divisor of at
    least a quarter of it does), the loss is a loop over token chunks,
    each under ``torch.utils.checkpoint``: only one chunk's logits exist
    at a time and the backward recomputes them.  A near-prime token count,
    or ``cfg.xent_impl="blocked"``, takes the blocked route
    (``losses.blocked_token_xent``), where the logits never exist at all;
    short inputs take the full logits."""
    hd = _lm_head(params, cfg).to(cfg.dtype)
    B, T, D = h.shape
    n_tok = B * T
    chunk = cfg.xent_chunk

    def token_xent(h_flat, t_flat, w_flat):
        logits = (h_flat.to(cfg.dtype) @ hd).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, t_flat.long()[:, None])[:, 0]
        return ((lse - gold) * w_flat).sum()

    h_flat = h.reshape(n_tok, D)
    t_flat = targets.reshape(n_tok)
    w_flat = torch.ones((n_tok,), dtype=torch.float32, device=h.device)
    if chunk and n_tok > chunk:
        # largest divisor of n_tok <= chunk, so odd token counts still
        # stream instead of falling back to the full (B*T, V) logits
        div = chunk
        while n_tok % div:
            div -= 1
        if div >= cfg.xent_chunk // 4 and cfg.xent_impl != "blocked":
            chunk = div
        else:
            xent = ((kernels or _DEFAULT_KERNELS).xent
                    or losses.blocked_token_xent)
            return xent(h_flat.to(cfg.dtype), hd, t_flat) / n_tok

    if chunk and 1 < chunk < n_tok:
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, n_tok, chunk):
            sl = slice(i, i + chunk)
            total = total + checkpoint(token_xent, h_flat[sl], t_flat[sl],
                                       w_flat[sl], use_reentrant=False)
        return total / n_tok
    return token_xent(h_flat, t_flat, w_flat) / n_tok


def encode_local(params, tokens, cfg: TransformerConfig, *, n_sp: int = 1,
                 sp_axis=None, tp_axis=None,
                 kernels: TrainKernels | None = None):
    """Final hidden states (B, T, D).  With ``cfg.remat`` each block runs
    under ``torch.utils.checkpoint`` (its activations are recomputed in
    the backward instead of stored)."""
    _no_axes(n_sp, sp_axis, tp_axis)
    T = tokens.shape[1]
    x = embed_local(params, tokens, cfg, sp_axis)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:
            x = checkpoint(_block, lp, x, cfg, n_sp, sp_axis, tp_axis, T,
                           kernels, use_reentrant=False)
        else:
            x = _block(lp, x, cfg, n_sp, sp_axis, tp_axis, T, kernels)
    return _layernorm(x, params["final_ln_scale"], params["final_ln_bias"])


def forward_local(params, tokens, cfg: TransformerConfig, *, n_sp: int = 1,
                  sp_axis=None, tp_axis=None):
    """Vocabulary logits (B, T, V) in f32."""
    x = encode_local(params, tokens, cfg, n_sp=n_sp, sp_axis=sp_axis,
                     tp_axis=tp_axis)
    logits = torch.einsum("btd,dv->btv", x.to(cfg.dtype),
                          _lm_head(params, cfg).to(cfg.dtype))
    return logits.float()


def lm_loss_local(params, tokens, targets, cfg: TransformerConfig, *,
                  kernels: TrainKernels | None = None, **axes):
    """Mean next-token (or MLM-style, given targets) cross entropy."""
    h = encode_local(params, tokens, cfg, kernels=kernels, **axes)
    return lm_head_loss(params, h, targets, cfg, kernels)


def init_cls_head(gen: torch.Generator, cfg: TransformerConfig,
                  n_classes: int, device=None) -> dict:
    """Sequence-classification head: mean pooling, then dense.  Drawn from
    ``gen`` on its device, placed on ``device``."""
    dev = resolve_device(device)
    w = torch.randn((cfg.d_model, n_classes), generator=gen, device=gen.device)
    return {"w_cls": (cfg.d_model ** -0.5 * w).to(device=dev,
                                                  dtype=cfg.param_dtype),
            "b_cls": torch.zeros((n_classes,), dtype=cfg.param_dtype,
                                 device=dev)}


def cls_loss_local(params, head, tokens, labels, cfg: TransformerConfig, *,
                   n_sp: int = 1, sp_axis=None, tp_axis=None):
    """Softmax cross entropy of the mean-pooled classifier."""
    x = encode_local(params, tokens, cfg, n_sp=n_sp, sp_axis=sp_axis,
                     tp_axis=tp_axis)
    pooled = x.float().mean(dim=1)
    logits = pooled @ head["w_cls"].float() + head["b_cls"]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


# --------------------------------------------------------------------------- KV-cached decode

def init_decode_cache(cfg: TransformerConfig, batch: int = 1,
                      device=None) -> list:
    """Per-layer ``(B, max_len, Kv, Dh)`` K/V buffers, zero-filled."""
    dev = resolve_device(device)
    shape = (batch, cfg.max_len, cfg.kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def _decode_attend(params, x, valid, write_kv, cfg: TransformerConfig,
                   attend=None, int8_fn=None, window: int = 1):
    """Shared per-row decode arithmetic over embedded queries ``x`` (N, D),
    ``N = B * window`` with a row's ``window`` queries adjacent.
    ``write_kv(layer, k, v) -> (ck, cv)`` commits the new K/V wherever
    the caller keeps it and returns the ``(B, T, Kv, Dh)`` view that the
    row's queries read (every write lands before any query reads);
    ``valid`` (N, T) masks each query's keys.  ``attend(layer, q)``
    optionally replaces that gather-read attention (the paged-attention
    kernel hook); ``int8_fn`` replaces the ``int8_matmul`` wrapper for
    int8 trees.  Returns f32 logits (N, V)."""
    dt = cfg.dtype
    scale = cfg.head_dim ** -0.5
    n_rep = cfg.n_heads // cfg.kv_heads
    for li, lp in enumerate(params["layers"]):
        h = _layernorm(x, lp["ln1_scale"], lp["ln1_bias"])
        q, k, v = _qkv_proj(lp, h, dt)                          # (N, H|Kv, Dh)
        ck, cv = write_kv(li, k, v)
        if attend is not None:
            att = attend(li, q)
        else:
            ck, cv = repeat_kv_heads(ck, n_rep), repeat_kv_heads(cv, n_rep)
            qw = q.float().reshape(-1, window, *q.shape[1:])    # (B, W, H, Dh)
            s = torch.einsum("bwhd,bthd->bwht", qw, ck.float()) * scale
            s = s.reshape(-1, *s.shape[2:])                     # (N, H, T)
            s = s.masked_fill(~valid[:, None, :], float("-inf"))
            p = torch.softmax(s, dim=-1).to(dt).float()
            att = torch.einsum("bwht,bthd->bwhd",
                               p.reshape(-1, window, *p.shape[1:]),
                               cv.float()).reshape(q.shape).to(dt)
        proj = torch.einsum("bhe,hed->bd", att, lp["wo"].to(dt))
        x = x + proj.to(x.dtype)
        h2 = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"])
        down = _ffn(lp, h2, dt, int8_fn) + lp["b2"].to(dt)
        x = x + down.to(x.dtype)
    h = _layernorm(x, params["final_ln_scale"], params["final_ln_bias"])
    if "head_q" in params:
        # int8-quantized serving tree: the LM head streams as int8
        return (int8_fn or int8_matmul)(h.to(dt), params["head_q"])
    head = (params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"])
    return (h.to(dt) @ head.to(dt)).to(torch.float32)


def _positions(pos, tokens) -> torch.Tensor:
    """``pos`` (an int, or a (B,) tensor of per-row positions) as (B,)
    int64 on ``tokens``' device."""
    return torch.as_tensor(pos, device=tokens.device).long().expand(
        tokens.shape)


def decode_step(params, cache, tokens, pos, cfg: TransformerConfig,
                int8_fn=None):
    """One incremental decode step: ``tokens`` (B,) at position ``pos``
    (an int, or a (B,) tensor of per-row positions).  Writes each row's
    new K/V into ``cache`` IN PLACE at its own position and returns
    ``(logits (B, V) f32, cache)``."""
    dt = cfg.dtype
    tok = tokens.long()
    pos_b = _positions(pos, tok)
    x = (params["tok_embed"][tok] + params["pos_embed"][pos_b]).to(dt)
    valid = (torch.arange(cfg.max_len, device=tok.device)[None, :]
             <= pos_b[:, None])
    rows = torch.arange(tok.shape[0], device=tok.device)

    def write_kv(li, k, v):
        c = cache[li]
        c["k"][rows, pos_b] = k.to(c["k"].dtype)
        c["v"][rows, pos_b] = v.to(c["v"].dtype)
        return c["k"], c["v"]

    logits = _decode_attend(params, x, valid, write_kv, cfg,
                            int8_fn=int8_fn)
    return logits, cache


def reset_cache_slots(cache, slot_mask) -> list:
    """Zero, IN PLACE, the K/V rows named by ``slot_mask`` (B,) bool."""
    m = slot_mask[:, None, None, None]
    for c in cache:
        c["k"].masked_fill_(m, 0)
        c["v"].masked_fill_(m, 0)
    return cache


# --------------------------------------------------------------------------- paged KV decode

def init_paged_cache(cfg: TransformerConfig, num_pages: int, page_size: int,
                     device=None) -> list:
    """Per-layer ``(num_pages, page_size, Kv, Dh)`` K/V pools shared by all
    serving slots and addressed through per-slot block tables.  For the
    int8 twin see ``ops.cuda.kv_quant.init_quantized_paged_cache``."""
    dev = resolve_device(device)
    shape = (num_pages, page_size, cfg.kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def reset_cache_pages(pages, page_mask) -> list:
    """Zero, IN PLACE, the physical pages named by ``page_mask`` (P,)
    bool; a quantized pool also resets those pages' scales to neutral."""
    m = page_mask[:, None, None, None]
    for c in pages:
        c["k"].masked_fill_(m, 0)
        c["v"].masked_fill_(m, 0)
        if "k_scale" in c:
            s0 = kv_quant.neutral_scale(c["k"].dtype)
            c["k_scale"].masked_fill_(page_mask[:, None], s0)
            c["v_scale"].masked_fill_(page_mask[:, None], s0)
    return pages


def paged_flat_index(block_table, positions, page_size: int):
    """Logical positions → indices into a ``(P*page_size, ...)`` view of
    the pool: ``bt[b, t // ps] * ps + t % ps`` for ``block_table``
    (B, n_pages) and ``positions`` (B, W); page lookups clamp to the
    table.  Returns int64 (B, W)."""
    n_pages = block_table.shape[1]
    positions = positions.long()
    page = torch.clamp(positions // page_size, max=n_pages - 1)
    return (torch.gather(block_table.long(), 1, page) * page_size
            + positions % page_size)


def gather_paged_kv(c, block_table, max_len: int):
    """One logical ``(B, max_len, Kv, Dh)`` view of the pool ``c``
    (P, ps, Kv, Dh) through ``block_table`` (B, n_pages)."""
    flat = _row_positions(c, block_table, max_len)
    return c.reshape((-1,) + tuple(c.shape[2:]))[flat]


def _row_positions(c, block_table, max_len):
    B = block_table.shape[0]
    t = torch.arange(max_len, device=block_table.device).expand(B, max_len)
    return paged_flat_index(block_table, t, c.shape[1])


def gather_paged_layer(c, block_table, max_len: int, dtype):
    """Logical ``(B, max_len, Kv, Dh)`` k and v views of one layer's pool
    dict ``c`` in ``dtype``; a quantized pool dequantizes the gathered
    rows by their pages' scales (elementwise the same values as the JAX
    package's dequantize-the-pool-then-gather)."""
    if "k_scale" not in c:
        return (gather_paged_kv(c["k"], block_table, max_len),
                gather_paged_kv(c["v"], block_table, max_len))
    flat = _row_positions(c["k"], block_table, max_len)
    page = flat // c["k"].shape[1]
    out = []
    for key in ("k", "v"):
        pool = c[key]
        rows = pool.reshape((-1,) + tuple(pool.shape[2:]))[flat]
        out.append((rows.to(torch.float32)
                    * c[key + "_scale"][page][..., None]).to(dtype))
    return out[0], out[1]


def scatter_rows(dst, idx, val) -> torch.Tensor:
    """``dst[idx[i]] = val[i]`` along axis 0, IN PLACE, where entries of
    ``idx`` outside ``[0, len(dst))`` are dropped (the JAX package's
    ``.at[idx].set(val, mode="drop")``; the window paths send positions
    past ``max_len`` to such a sentinel).

    The drop costs no host sync (a boolean-mask index would, through
    ``nonzero``) and never clamps a sentinel onto a live row, where it
    could race a real write of the same call.  Instead each dropped entry
    becomes a copy of the call's first in-range entry, index and value
    alike, so ``index_put_`` writes the same bytes there however it
    orders duplicates; with no entry in range, every entry rewrites row 0
    with the bytes it already holds.  That first entry is picked with a
    one-element ``index_select``: a 0-d tensor index would read the
    index on the host.  Returns ``dst``."""
    if idx.numel() == 0:
        return dst
    idx = idx.long()
    val = val.to(dst.dtype)
    ok = (idx >= 0) & (idx < dst.shape[0])
    # (1,): 0 when none is in range
    first = torch.argmax(ok.to(torch.int32)).reshape(1)
    live = ok.index_select(0, first)                              # (1,)
    d_idx = torch.where(live, idx.index_select(0, first), 0)      # (1,)
    lead = (1,) * (val.dim() - 1)
    d_val = torch.where(live.reshape((1,) + lead),
                        val.index_select(0, first), dst[:1])      # (1, ...)
    okv = ok.reshape((-1,) + lead)
    dst.index_put_((torch.where(ok, idx, d_idx),),
                   torch.where(okv, val, d_val))
    return dst


def scatter_paged_layer(c, flat, k, v) -> dict:
    """Commit token K/V rows ``k``/``v`` (N, Kv, Dh) at flat pool indices
    ``flat`` (N,) into one layer's pool dict ``c``, IN PLACE.  Indices
    outside the pool are dropped (:func:`scatter_rows`; the window
    paths' sentinel is ``n_phys * page_size``).  Float pools store the
    rows as they are; quantized pools quantize at the write: dequantize
    the whole pool, scatter, requantize against monotone per-page absmax
    scales (the JAX package's semantics, whole-pool cost included), so
    pages no write touched keep their bytes."""
    return _scatter_paged(c, flat, k, v, scatter_rows)


def _put_rows(dst, idx, val) -> torch.Tensor:
    """``dst[idx] = val`` IN PLACE, for ``idx`` known to lie in ``dst``:
    the paged step's own indices, whose page lookups
    :func:`paged_flat_index` clamps to the block table, so
    :func:`scatter_rows`' drop would cost a dozen launches a call for
    nothing."""
    dst[idx] = val.to(dst.dtype)
    return dst


def _scatter_paged(c, flat, k, v, put) -> dict:
    """:func:`scatter_paged_layer` with the row write ``put(dst, idx,
    val)``."""
    if "k_scale" not in c:
        for key, val in (("k", k), ("v", v)):
            pool = c[key]
            put(pool.view((-1,) + tuple(pool.shape[2:])), flat, val)
        return c
    for key, val in (("k", k), ("v", v)):
        skey = key + "_scale"
        f = kv_quant.dequantize_pool(c[key], c[skey], torch.float32)
        put(f.view((-1,) + tuple(f.shape[2:])), flat, val)
        q, s = kv_quant.requantize_pool(f, c[skey], c[key].dtype)
        c[key].copy_(q)
        c[skey].copy_(s)
    return c


def decode_step_paged(params, pages, block_tables, tokens, pos,
                      cfg: TransformerConfig, attn_fn=None, int8_fn=None):
    """Paged twin of :func:`decode_step`: K/V live in the shared page pool
    and each row reads/writes through its block-table row.  The new K/V
    is scattered (IN PLACE) to page ``bt[b, pos // ps]`` before attending.
    Without ``attn_fn`` attention runs over a gather of the row's logical
    ``[0, max_len)`` K/V; ``attn_fn`` swaps that read for a registry
    candidate ``(q, k_pages, v_pages, block_tables, lengths)`` (with
    ``k_scale, v_scale`` after the pools for quantized pools).
    ``block_tables`` is (B, n_pages) int32.  Returns ``(logits (B, V)
    f32, pages)``."""
    dt = cfg.dtype
    ps = pages[0]["k"].shape[1]
    tok = tokens.long()
    pos_b = _positions(pos, tok)
    x = (params["tok_embed"][tok] + params["pos_embed"][pos_b]).to(dt)
    valid = (torch.arange(cfg.max_len, device=tok.device)[None, :]
             <= pos_b[:, None])
    flat = paged_flat_index(block_tables, pos_b[:, None], ps)[:, 0]    # (B,)

    def write_kv(li, k, v):
        _scatter_paged(pages[li], flat, k, v, _put_rows)
        if attn_fn is not None:
            return None, None  # the attend hook reads the pool directly
        return gather_paged_layer(pages[li], block_tables, cfg.max_len, dt)

    attend = None
    if attn_fn is not None:
        lengths = (pos_b + 1).to(torch.int32)

        def attend(li, q):
            c = pages[li]
            q = q.contiguous()
            if "k_scale" in c:
                return attn_fn(q, c["k"], c["v"], c["k_scale"], c["v_scale"],
                               block_tables, lengths).to(dt)
            return attn_fn(q, c["k"], c["v"], block_tables, lengths).to(dt)

    logits = _decode_attend(params, x, valid, write_kv, cfg, attend=attend,
                            int8_fn=int8_fn)
    return logits, pages


def _window(params, tokens, pos, cfg: TransformerConfig):
    """The shared front of the verify windows: ``tokens`` (B, W) at
    positions ``pos[b] .. pos[b]+W-1``.  Returns the embedded queries
    (B*W, D), their validity masks (B*W, T), the window positions (B, W)
    and whether each lies below ``max_len``; positions past it embed and
    mask as ``max_len - 1`` (their writes are dropped by the caller)."""
    B, W = tokens.shape
    T = cfg.max_len
    tok = tokens.long().reshape(B * W)
    pos_b = torch.as_tensor(pos, device=tok.device).long().expand(B)
    wpos = pos_b[:, None] + torch.arange(W, device=tok.device)[None, :]
    pos2 = torch.clamp(wpos, max=T - 1).reshape(B * W)
    x = (params["tok_embed"][tok] + params["pos_embed"][pos2]).to(cfg.dtype)
    valid = torch.arange(T, device=tok.device)[None, :] <= pos2[:, None]
    return x, valid, wpos, wpos < T


def decode_window(params, cache, tokens, pos, cfg: TransformerConfig):
    """Speculative verify window: process ``tokens`` (B, W) at positions
    ``pos[b] .. pos[b]+W-1`` in one pass, returning logits for every
    window position.  The window folds into the batch (N = B*W rows of
    the same per-row ops as :func:`decode_step`); all W writes land in
    ``cache`` (IN PLACE) before any query reads, and window position w
    attends exactly the keys a sequential step at ``pos+w`` would see, so
    per row it is W sequential ``decode_step`` calls up to summation
    order.  Positions past ``max_len - 1`` are dropped writes (sentinel
    ``B * max_len``), never clamped onto a live row.  Returns ``(logits
    (B, W, V) f32, cache)``."""
    B, W = tokens.shape
    T = cfg.max_len
    x, valid, wpos, ok = _window(params, tokens, pos, cfg)
    row = torch.arange(B, device=x.device)[:, None]
    flat = torch.where(ok, row * T + wpos,
                       torch.full_like(wpos, B * T)).reshape(B * W)

    def write_kv(li, k, v):
        c = cache[li]
        for key, val in (("k", k), ("v", v)):
            buf = c[key]
            scatter_rows(buf.view((B * T,) + tuple(buf.shape[2:])), flat, val)
        return c["k"], c["v"]

    logits = _decode_attend(params, x, valid, write_kv, cfg, window=W)
    return logits.reshape(B, W, -1), cache


def decode_window_paged(params, pages, block_tables, tokens, pos,
                        cfg: TransformerConfig):
    """Paged twin of :func:`decode_window`: the W window writes scatter
    into the page pool (IN PLACE) through the block table, positions past
    ``max_len - 1`` becoming dropped sentinel writes (``n_phys *
    page_size``), then each window query attends a gather of its row's
    logical K/V, as :func:`decode_step_paged` without ``attn_fn`` does.
    Returns ``(logits (B, W, V) f32, pages)``."""
    B, W = tokens.shape
    T = cfg.max_len
    ps = pages[0]["k"].shape[1]
    n_phys = pages[0]["k"].shape[0]
    x, valid, wpos, ok = _window(params, tokens, pos, cfg)
    flat = torch.where(ok, paged_flat_index(block_tables, wpos, ps),
                       torch.full_like(wpos, n_phys * ps)).reshape(B * W)

    def write_kv(li, k, v):
        scatter_paged_layer(pages[li], flat, k, v)
        return gather_paged_layer(pages[li], block_tables, T, cfg.dtype)

    logits = _decode_attend(params, x, valid, write_kv, cfg, window=W)
    return logits.reshape(B, W, -1), pages


def gumbel_noise(u: torch.Tensor) -> torch.Tensor:
    """``log(-log(u))`` of uniforms ``u``: :func:`sample_token` picks
    ``argmax(logits / temperature - gumbel_noise(u))``.  Elementwise, so
    a row computed alone has the bits it has inside a larger tensor."""
    return torch.log(-torch.log(u))


def sample_token(logits: torch.Tensor, temperature: float,
                 gen: torch.Generator) -> torch.Tensor:
    """Draw one token id from ``softmax(logits / temperature)`` (one row)
    by the Gumbel-max trick with noise from ``gen``; no host sync.  Each
    call advances ``gen`` by exactly one draw of ``V`` uniforms — the
    per-request stream the serving engine shares with
    :meth:`TransformerLM.sample`."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    return torch.argmax(logits.float() / temperature - gumbel_noise(u))


# --------------------------------------------------------------------------- model facade

class TransformerLM:
    """The flagship LM on one device: training steps and decoding.

    ``mesh`` must be None: the sharded train step and ZeRO-1 come with the
    multi-device port (``ROADMAP.md`` A10)."""

    def __init__(self, cfg: TransformerConfig, mesh=None, *, device=None):
        if mesh is not None:
            raise NotImplementedError("a mesh (sharded training) comes with "
                                      "the multi-device port")
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, gen: torch.Generator | None = None) -> dict:
        """Parameters drawn from ``gen`` (default: a CPU generator seeded
        0, so the default is deterministic)."""
        if gen is None:
            gen = torch.Generator().manual_seed(0)
        return init_params(gen, self.cfg, self.device)

    def forward(self, params, tokens) -> torch.Tensor:
        """f32 vocabulary logits (B, T, V) of (B, T) tokens."""
        return forward_local(params, self._to_device(tokens), self.cfg)

    def score(self, params, tokens, targets) -> float:
        """Mean token cross entropy; ``exp(score)`` is perplexity."""
        with torch.no_grad():
            return float(lm_loss_local(params, self._to_device(tokens),
                                       self._to_device(targets), self.cfg))

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=self.device)

    # -- train steps ----------------------------------------------------
    @staticmethod
    def _default_tx(lr: float):
        """SGD with momentum, the reference's finetune default."""
        return tx_mod.chain(tx_mod.momentum(0.9), tx_mod.sgd_lr(lr))

    def _decay_mask(self, tree):
        """Bool tree of the weight-class (decayed) leaves of ``tree``; None
        keeps the transforms' ndim >= 2 default, which is right for this
        class's layout (a subclass that re-lays parameters out names its
        leaves here)."""
        return None

    def init_opt(self, params, tx=None, lr: float = 1e-3):
        """Optimizer state ``(step_count, tx_state)`` for the steps below,
        for the plain tree and the ``{"backbone", "head"}`` finetune tree
        alike; ``step_count`` is a Python int."""
        tx = tx if tx is not None else self._default_tx(lr)
        return 0, tx.init(params)

    def _build_step(self, tx, loss_of):
        """``step(tree, opt, *data) -> (tree, opt, loss)``: value and
        gradient of ``loss_of(tree, *data)``, the transform chain (weight
        decay on the leaves ``_decay_mask`` names), then
        ``apply_updates``.  Functional: the returned tree and state are new
        tensors and the caller's are not modified (nor marked as requiring
        grad).  ``loss`` is a 0-d tensor on the device (no host sync)."""

        def step(tree, opt, *data):
            count, tx_state = opt
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(tree)]
            live = tree_unflatten(tree, leaves)
            loss = loss_of(live, *data)
            grads = tree_unflatten(tree, torch.autograd.grad(
                loss, leaves, allow_unused=True, materialize_grads=True))
            with torch.no_grad():
                frozen = tree_unflatten(tree, [p.detach() for p in leaves])
                with tx_mod.decay_mask_override(self._decay_mask(frozen)):
                    updates, tx_state = tx.update(grads, tx_state, frozen,
                                                  count)
                new_tree = tx_mod.apply_updates(frozen, updates)
            return new_tree, (count + 1, tx_state), loss.detach()

        return step

    def build_train_step(self, tx=None, lr: float = 1e-3):
        """LM train step over any ``GradientTransform`` (default: SGD with
        momentum): ``step(params, opt, tokens, targets) -> (params, opt,
        loss)`` with ``opt = (step_count, tx_state)``."""
        cfg = self.cfg
        tx = tx if tx is not None else self._default_tx(lr)

        def loss_of(params, tokens, targets):
            return lm_loss_local(params, tokens, targets, cfg)

        return self._build_step(tx, loss_of)

    # -- BERT-style sequence-classification fine-tune -------------------
    def init_finetune(self, gen: torch.Generator, n_classes: int,
                      params=None) -> dict:
        """``{"backbone", "head"}`` tree for ``build_finetune_step``; the
        head is drawn from ``gen`` after the backbone (if drawn)."""
        backbone = params if params is not None else self.init(gen)
        head = init_cls_head(gen, self.cfg, n_classes, self.device)
        return {"backbone": backbone, "head": head}

    def build_finetune_step(self, tx=None, lr: float = 2e-5):
        """Classifier fine-tune step: ``step(tree, opt, tokens, labels) ->
        (tree, opt, loss)`` over ``{"backbone": ..., "head": ...}``."""
        cfg = self.cfg
        tx = tx if tx is not None else self._default_tx(lr)

        def loss_of(tree, tokens, labels):
            return cls_loss_local(tree["backbone"], tree["head"], tokens,
                                  labels, cfg)

        return self._build_step(tx, loss_of)

    def fit(self, params, opt, batches, *, tx=None, lr: float = 1e-3,
            epochs: int = 1, finetune: bool = False,
            checkpoint_manager=None, checkpoint_every: int = 0,
            resume: bool = True):
        """Training loop with auto-checkpoint/resume over ``batches`` (a
        list of ``(tokens, targets | labels)`` pairs of numpy arrays or
        tensors) to ``epochs * len(batches)`` total steps counted by the
        optimizer's step count, so a restored state continues where it left
        off.  With ``checkpoint_manager`` (``parallel.CheckpointManager``)
        and ``resume``, the newest valid checkpoint is restored first; a
        save (params, the whole ``opt``, the cursor) follows every
        ``checkpoint_every`` steps and the end (once, where the two meet;
        the reference writes that step twice).  Batches reach the device
        through ``datasets.prefetch_to_device`` (pinned memory, a copy
        stream).  Returns ``(params, opt, losses)`` with the losses as
        floats, read once at the end."""
        from ..datasets.iterator import prefetch_to_device

        tx = tx if tx is not None else self._default_tx(lr)
        step_fn = (self.build_finetune_step(tx) if finetune
                   else self.build_train_step(tx))
        if (checkpoint_manager is not None and resume
                and checkpoint_manager.latest_step() is not None):
            r = checkpoint_manager.restore(params, tstate_template=opt)
            params, opt = r["params"], r["tstate"]

        def save():
            checkpoint_manager.save(int(opt[0]), params, tstate=opt,
                                    data_cursor=int(opt[0]))

        losses = []
        start, total = int(opt[0]), epochs * len(batches)
        feed = (tuple(batches[k % len(batches)]) for k in range(start, total))
        saved = None
        for a, b in prefetch_to_device(feed, size=2, device=self.device):
            params, opt, loss = step_fn(params, opt, a, b)
            losses.append(loss)   # stays on the device; read once below
            if (checkpoint_manager is not None and checkpoint_every > 0
                    and int(opt[0]) % checkpoint_every == 0):
                save()
                saved = int(opt[0])
        losses = [float(x) for x in losses]
        if checkpoint_manager is not None and losses \
                and saved != int(opt[0]):
            save()
        return params, opt, losses

    def sample(self, params, prime, length: int, temperature: float = 1.0,
               seed: int = 0, kv_cache: bool = False) -> list:
        """Temperature-sampled continuation of ``prime`` (greedy when
        ``temperature <= 0``).  Two paths: the default recomputes the full
        forward (:func:`forward_local`) over a ``(1, max_len)`` token
        buffer for every generated token, so on the card it runs the
        training kernels (attention, fused residual+LayerNorm) each
        token; ``kv_cache=True`` decodes incrementally through
        :func:`decode_step`.  Sampled tokens come from a
        ``torch.Generator`` seeded with ``seed`` through
        :func:`sample_token`, one draw per generated token on either
        path, so both give the same tokens for a seed (up to summation
        order), and the serving engine reproduces this stream exactly for
        a request with the same seed.  Torch cannot reproduce the JAX
        package's threefry stream, so only greedy decoding matches it."""
        cfg = self.cfg
        if not cfg.causal:
            raise ValueError("sampling needs a causal LM (cfg.causal=True)")
        P = len(prime)
        if not (1 <= P and P + length <= cfg.max_len):
            raise ValueError(f"prime {P} + length {length} must fit "
                             f"max_len {cfg.max_len}")
        dev = params["tok_embed"].device
        greedy = temperature <= 0.0
        gen = None if greedy else torch.Generator(device=dev).manual_seed(seed)
        toks = torch.zeros((cfg.max_len,), dtype=torch.long, device=dev)
        toks[:P] = torch.as_tensor(list(prime), dtype=torch.long)

        def pick(logits):
            return (torch.argmax(logits) if greedy else
                    sample_token(logits, temperature, gen))

        with torch.no_grad():
            if kv_cache:
                cache = init_decode_cache(cfg, 1, dev)
                for i in range(P + length - 1):
                    logits, _ = decode_step(params, cache, toks[i:i + 1], i,
                                            cfg)
                    if i + 1 >= P:
                        toks[i + 1] = pick(logits[0])
            else:
                for i in range(P - 1, P + length - 1):
                    logits = forward_local(params, toks[None], cfg)[0, i]
                    toks[i + 1] = pick(logits)
        return toks[:P + length].tolist()

    def beam_search(self, params, prime, length: int, beam_width: int = 5
                    ) -> tuple[list, float]:
        """Highest-log-likelihood continuation of ``prime``: ``(token
        sequence, total log prob)``.  The beam is the batch axis of the
        KV-cached :func:`decode_step` (``params`` may be a serving tree
        from ``quantize_params_for_decode``, whose FFN and head then run
        ``int8_matmul`` at M = beam width); the top-k bookkeeping (sort
        W·V scores) runs on the host each step, as in the JAX package,
        and the cache rows are reordered on the device by
        ``index_select``."""
        cfg = self.cfg
        if not cfg.causal:
            raise ValueError("beam search needs a causal LM "
                             "(cfg.causal=True)")
        # more beams than vocabulary entries cannot all be distinct
        P, W = len(prime), min(beam_width, cfg.vocab_size)
        if not (1 <= P and P + length <= cfg.max_len):
            raise ValueError(f"prime {P} + length {length} must fit "
                             f"max_len {cfg.max_len}")
        dev = params["tok_embed"].device
        toks = torch.zeros((W, cfg.max_len), dtype=torch.long, device=dev)
        toks[:, :P] = torch.as_tensor(list(prime), dtype=torch.long)
        cache = init_decode_cache(cfg, W, dev)
        scores = np.zeros(W)
        with torch.no_grad():
            for i in range(P - 1):                       # prefill
                decode_step(params, cache, toks[:, i], i, cfg)
            for i in range(P - 1, P - 1 + length):
                logits, _ = decode_step(params, cache, toks[:, i], i, cfg)
                logp = torch.log_softmax(logits, dim=-1).cpu().numpy()
                if i == P - 1:
                    # all beams are clones of the prime: branch the top-W
                    # tokens from ONE row (else W duplicate beams)
                    top = np.argsort(-logp[0])[:W]
                    beam_idx, next_toks = np.zeros(W, int), top
                    scores = logp[0][top]
                else:
                    flat = (scores[:, None] + logp).reshape(-1)
                    top = np.argsort(-flat)[:W]
                    beam_idx, next_toks = np.divmod(top, logp.shape[1])
                    scores = flat[top]
                sel = torch.as_tensor(beam_idx, dtype=torch.long, device=dev)
                toks = toks.index_select(0, sel)
                toks[:, i + 1] = torch.as_tensor(next_toks, dtype=torch.long,
                                                 device=dev)
                cache = [{k: c.index_select(0, sel) for k, c in layer.items()}
                         for layer in cache]
        best = int(np.argmax(scores))
        return toks[best, :P + length].tolist(), float(scores[best])
