"""train_mfu: the whole train step's share of the card's bf16 peak.

Model flops a token, counted from the configuration at the cell's
sequence length: 6 x (the matrix weights of the blocks + the tied head)
for the forward and backward products, plus 12 x layers x d_model x the
(query, key) pairs a token attends to (T for bidirectional attention,
(T + 1) / 2 on average under a causal mask).  No recompute is counted
and the embedding lookups, LayerNorms and biases are not.  Times the
tokens of every step of the window, over the window's seconds and the
card's published dense bf16 rate.
"""

from h100bench.core.model import matmul_params


def flops_per_token(model: dict, seq: int) -> float:
    pairs = seq * (seq + 1) / 2 if model["causal"] else seq * seq
    attn = 12 * model["n_layers"] * model["d_model"] * pairs / seq
    return 6 * matmul_params(model) + attn


def read(ctx):
    w = ctx.window
    if not w.get("seconds") or "seq" not in w:
        return None
    flops = flops_per_token(ctx.model, w["seq"]) * w["tokens"]
    return 100.0 * flops / w["seconds"] / ctx.peaks.bf16_flops
