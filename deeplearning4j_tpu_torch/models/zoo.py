"""Model zoo: the speculative-decoding draft.

Port of ``draft_lm`` from ``deeplearning4j_tpu/models/zoo.py``; the rest
of the zoo (MLP, DBN, autoencoders, LeNet) comes with the DL4J layer set.
"""

from __future__ import annotations

import dataclasses

import torch

from .transformer import TransformerLM


def draft_lm(target_cfg, *, n_layers: int = 1, width_divisor: int = 2,
             seed: int = 0, device=None):
    """A shallower, thinner ``TransformerLM`` sharing the target's
    ``vocab_size`` and ``max_len`` (the speculative engine's contract:
    the draft proposes token ids the target verifies, and its KV cache is
    indexed by the same positions).  Returns ``(model, params)`` with the
    params drawn from a CPU generator seeded ``seed`` and placed on
    ``device`` (default ``cuda``).  A bad draft only lowers
    ``serving.spec_accept_len``; it never changes served tokens."""
    heads = max(1, target_cfg.n_heads // width_divisor)
    d_model = max(heads * (target_cfg.d_model // target_cfg.n_heads),
                  target_cfg.d_model // width_divisor)
    d_model -= d_model % heads
    cfg = dataclasses.replace(
        target_cfg, n_layers=max(1, n_layers), d_model=d_model,
        n_heads=heads, d_ff=max(d_model, target_cfg.d_ff // width_divisor),
        remat=False)
    model = TransformerLM(cfg, device=device)
    return model, model.init(torch.Generator().manual_seed(seed))
