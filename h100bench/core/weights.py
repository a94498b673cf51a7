"""The weights of a run, made from ``--seed`` on the device.

One ``torch.randn`` over every random leaf at once on a generator of
the run's device, cut into the leaves and scaled: the same seed gives the
same weights, bit for bit, on the same device.  Scales follow the
scaled-normal init the port uses (``d ** -0.5`` for the projections,
0.02 for the embeddings); LayerNorm scales are 1 and biases 0.  The
layout is the one the port's ``TransformerLM`` takes, which the plain
reference reads too.
"""

from __future__ import annotations

import torch


def shapes(model: dict) -> list:
    """``[(path, shape, scale)]``; scale None is a constant (LayerNorm
    scale 1, biases 0)."""
    d, h = model["d_model"], model["n_heads"]
    dh, f = d // h, model["d_ff"]
    out = [("tok_embed", (model["vocab_size"], d), 0.02),
           ("pos_embed", (model["max_len"], d), 0.02)]
    for i in range(model["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1_scale", (d,), None), (p + "ln1_bias", (d,), None),
                (p + "wqkv", (d, 3, h, dh), d ** -0.5),
                (p + "wo", (h, dh, d), (h * dh) ** -0.5),
                (p + "ln2_scale", (d,), None), (p + "ln2_bias", (d,), None),
                (p + "w1", (d, f), d ** -0.5), (p + "b1", (f,), None),
                (p + "w2", (f, d), f ** -0.5), (p + "b2", (d,), None)]
    out += [("final_ln_scale", (d,), None), ("final_ln_bias", (d,), None)]
    return out


def make(model: dict, seed: int, device) -> dict:
    """The f32 parameter tree of ``model`` for ``seed`` on ``device``."""
    spec = shapes(model)
    n = sum(_numel(s) for _, s, sc in spec if sc is not None)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn((n,), generator=gen, device=device,
                       dtype=torch.float32)
    leaves, off = {}, 0
    for path, shape, scale in spec:
        if scale is None:
            value = 1.0 if path.endswith("_scale") else 0.0
            leaves[path] = torch.full(shape, value, dtype=torch.float32,
                                      device=device)
            continue
        k = _numel(shape)
        leaves[path] = flat[off:off + k].view(shape).mul_(scale)
        off += k
    return tree(leaves, model["n_layers"])


def tree(leaves: dict, n_layers: int) -> dict:
    out = {k: v for k, v in leaves.items() if not k.startswith("layers.")}
    out["layers"] = [{} for _ in range(n_layers)]
    for k, v in leaves.items():
        if k.startswith("layers."):
            _, i, name = k.split(".", 2)
            out["layers"][int(i)][name] = v
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
