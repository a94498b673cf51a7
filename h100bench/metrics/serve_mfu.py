"""serve_mfu: the serving loop's useful work over the card's bf16 peak.

Model flops of every position a request ran through the model (its
prompt, then each generated token but the last): 2 x (the matrix weights
of the blocks + the tied head) a position, plus 4 x layers x d_model x
the keys it attends to (its position + 1).  Each request counts by the
share of its life inside the window, as the window's token rate does;
over the window's seconds and the card's published dense bf16 rate.
"""

from h100bench.core.model import matmul_params


def request_flops(model: dict, prompt: int, tokens: int) -> float:
    m = prompt + tokens - 1             # positions run through the model
    return (2 * matmul_params(model) * m
            + 4 * model["n_layers"] * model["d_model"] * m * (m + 1) / 2)


def read(ctx):
    w = ctx.window
    if not w.get("seconds") or "requests" not in w:
        return None
    flops = sum(r["share"] * request_flops(ctx.model, r["prompt"],
                                           r["tokens"])
                for r in w["requests"])
    return 100.0 * flops / w["seconds"] / ctx.peaks.bf16_flops
