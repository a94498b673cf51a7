"""The plain reference of both configurations: a pre-LN transformer with
learned positions, tanh-GELU and a tied head, in float32 PyTorch.

Independent of the program: it imports nothing of ``deeplearning4j_tpu_torch``
and takes the weights the benchmark made (``core/weights.py``), in the
parameter layout the benchmark hands to both sides (``wqkv`` (D, 3, H, Dh),
``wo`` (H, Dh, D), ``w1``/``b1``/``w2``/``b2``, ``tok_embed`` (V, D),
``pos_embed`` (P, D), LayerNorm scales and biases).  Every product runs
in float32 with TF32 off (:func:`exact_float32`).

``quant`` turns the reference into the comparison's control, computed one
step of precision below what the configuration states:

- ``"fp8"``: every matrix product's operands rounded to float8 e4m3 with
  a per-tensor scale (the step below bf16 compute); the backward sees the
  rounded operands (straight-through);
- ``"int4"``: the FFN and head weights as per-output-channel absmax int4,
  and K/V as per-(16-position page, head) absmax int4 (the step below the
  serving path's int8 weights and int8 pages).
"""

from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0          # float8 e4m3fn's largest finite value
INT4_MAX = 7.0
KV_PAGE = 16


@contextlib.contextmanager
def exact_float32():
    """float32 products in full float32 (no TF32) inside the block."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, with a
    straight-through gradient."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = FP8_MAX / amax
    r = (x.detach() * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return x + (r - x).detach()


def int4_columns(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) matrix through per-column absmax int4 and back."""
    amax = w.abs().amax(dim=0, keepdim=True)
    s = torch.where(amax > 0, amax, torch.ones_like(amax)) / INT4_MAX
    return torch.clamp(torch.round(w / s), -INT4_MAX, INT4_MAX) * s


def int4_pages(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, Dh) keys or values through per-(page of 16 positions,
    head) absmax int4 and back."""
    B, T, H, Dh = x.shape
    pad = (-T) % KV_PAGE
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    xp = xp.reshape(B, -1, KV_PAGE, H, Dh)
    amax = xp.abs().amax(dim=(2, 4), keepdim=True)
    s = torch.where(amax > 0, amax, torch.ones_like(amax)) / INT4_MAX
    q = torch.clamp(torch.round(xp / s), -INT4_MAX, INT4_MAX) * s
    return q.reshape(B, -1, H, Dh)[:, :T]


def layernorm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def hidden(params: dict, tokens: torch.Tensor, model: dict,
           quant: str | None = None) -> torch.Tensor:
    """Final hidden states (B, T, D) of (B, T) tokens."""
    mm = _fp8 if quant == "fp8" else (lambda t: t)
    eps = model["layer_norm_eps"]
    causal = model["causal"]
    B, T = tokens.shape
    x = params["tok_embed"][tokens] + params["pos_embed"][:T][None]
    if causal:
        keep = torch.ones((T, T), dtype=torch.bool,
                          device=tokens.device).tril()
    for lp in params["layers"]:
        h = layernorm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
        D, _, H, Dh = lp["wqkv"].shape
        qkv = (mm(h) @ mm(lp["wqkv"].reshape(D, 3 * H * Dh))).reshape(
            B, T, 3, H, Dh)
        q, k, v = qkv.unbind(2)
        if quant == "int4":
            k, v = int4_pages(k), int4_pages(v)
        s = torch.einsum("bqhd,bkhd->bhqk", mm(q), mm(k)) / math.sqrt(Dh)
        if causal:
            s = s.masked_fill(~keep, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", mm(p), mm(v)).reshape(B, T, H * Dh)
        x = x + mm(o) @ mm(lp["wo"].reshape(H * Dh, D))
        h2 = layernorm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
        w1, w2 = lp["w1"], lp["w2"]
        if quant == "int4":
            w1, w2 = int4_columns(w1), int4_columns(w2)
        u = gelu_tanh(mm(h2) @ mm(w1) + lp["b1"])
        x = x + mm(u) @ mm(w2) + lp["b2"]
    return layernorm(x, params["final_ln_scale"], params["final_ln_bias"], eps)


def head_matrix(params: dict, quant: str | None = None) -> torch.Tensor:
    """The tied head (D, V)."""
    head = params["tok_embed"].t()
    return int4_columns(head) if quant == "int4" else head


def logits(params: dict, tokens: torch.Tensor, model: dict,
           quant: str | None = None) -> torch.Tensor:
    """f32 vocabulary logits (B, T, V)."""
    h = hidden(params, tokens, model, quant)
    head = head_matrix(params, quant)
    if quant == "fp8":
        return _fp8(h) @ _fp8(head)
    return h @ head


def token_loss_sum(params: dict, tokens, targets, model: dict,
                   quant: str | None = None) -> torch.Tensor:
    """Sum over every position of the token cross entropy."""
    lg = logits(params, tokens, model, quant)
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, targets[..., None])[..., 0]
    return (lse - gold).sum()


# --------------------------------------------------------------- training

def warmup_cosine(peak: float, warmup: int, total: int, step: int) -> float:
    """Linear warm-up from 0, then cosine decay to 0 (step counts from 0)."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return 0.5 * peak * (1.0 + math.cos(math.pi * frac))


def leaves(tree: dict) -> dict:
    """``{path: tensor}`` of a parameter tree (``layers.3.w1``)."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            for i, lp in enumerate(v):
                for kk, vv in lp.items():
                    out[f"layers.{i}.{kk}"] = vv
        else:
            out[k] = v
    return out


def grads(params: dict, tokens, targets, model: dict, rows: int,
          quant: str | None = None) -> tuple[float, dict]:
    """Mean token loss of the batch and its gradient per leaf, the batch
    run ``rows`` rows at a time so that it fits."""
    flat = leaves(params)
    live = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    tree = _unflatten(params, live)
    n_tok = tokens.numel()
    total = 0.0
    acc = {k: torch.zeros_like(v) for k, v in live.items()}
    for i in range(0, tokens.shape[0], rows):
        loss = token_loss_sum(tree, tokens[i:i + rows], targets[i:i + rows],
                              model, quant) / n_tok
        g = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        for (k, _), gi in zip(live.items(), g):
            if gi is not None:
                acc[k] += gi
        total += float(loss.detach())
    return total, acc


def _unflatten(template: dict, flat: dict) -> dict:
    out = {}
    for k, v in template.items():
        if k == "layers":
            out[k] = [{kk: flat[f"layers.{i}.{kk}"] for kk in lp}
                      for i, lp in enumerate(v)]
        else:
            out[k] = flat[k]
    return out


class AdamW:
    """AdamW with bias correction and decoupled weight decay on the
    matrices (leaves of two or more dimensions), scaled by the schedule."""

    def __init__(self, params: dict, opt: dict):
        self.opt = opt
        self.mu = {k: torch.zeros_like(v) for k, v in leaves(params).items()}
        self.nu = {k: torch.zeros_like(v) for k, v in leaves(params).items()}
        self.step = 0

    def update(self, params: dict, g: dict) -> dict:
        o = self.opt
        b1, b2, eps = o["b1"], o["b2"], o["eps"]
        lr = warmup_cosine(o["lr"], o["warmup_steps"], o["total_steps"],
                           self.step)
        t = self.step + 1
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        new = {}
        for k, w in leaves(params).items():
            self.mu[k] = b1 * self.mu[k] + (1 - b1) * g[k]
            self.nu[k] = b2 * self.nu[k] + (1 - b2) * g[k] * g[k]
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + eps)
            if w.dim() >= 2:
                upd = upd + o["weight_decay"] * w
            new[k] = w - lr * upd
        self.step += 1
        return _unflatten(params, new)
