"""The one generator of every traffic mix, driven by the mix's file.

- ``kind: "train"``: ``batches`` distinct batches of ``batch`` x ``seq``
  token ids drawn uniformly from the vocabulary, made on the device ahead
  of time; targets are the tokens shifted by one (``targets: "next"``).
- ``kind: "serve"``: a closed loop of ``clients`` clients, each with its
  own list of requests.  Every seed gets the same multiset of sizes
  (prompt lengths and output budgets spread evenly over their ranges,
  paired by the mix's own ``size_seed``) in another order, and its own
  token ids, so two seeds do the same work.  Each client's first request
  takes its budget from ``ramp_output_tokens``: the ramp's completions
  spread out and the window opens on a steady state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: odd 64-bit mixer: the data stream's seed differs from the weights'
_MIX = 0x9E3779B97F4A7C15


def data_seed(seed: int) -> int:
    return (seed * _MIX + 1) % (1 << 63)


def train_batches(traffic: dict, vocab: int, seed: int, device) -> list:
    """``[(tokens, targets)]`` int64 on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(data_seed(seed))
    b, t = traffic["batch"], traffic["seq"]
    high = traffic.get("token_id_high", vocab)
    toks = torch.randint(0, high, (traffic["batches"], b, t), generator=gen,
                         device=device)
    if traffic.get("targets", "next") != "next":
        raise ValueError(f"unknown targets {traffic['targets']!r}")
    tgts = torch.roll(toks, -1, dims=2)
    return [(toks[i], tgts[i]) for i in range(traffic["batches"])]


@dataclasses.dataclass
class Request:
    client: int
    index: int              # the client's n-th request
    prompt: list
    budget: int


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` integers spread evenly over ``[lo, hi]``."""
    return lo + np.floor((np.arange(n) + 0.5) / n * (hi - lo + 1)).astype(
        np.int64)


def serve_plan(traffic: dict, seed: int) -> list:
    """Per client, its requests in order (``[[Request]]``)."""
    c = traffic["clients"]
    r = traffic["requests_per_client"]
    n = c * (r - 1)
    fixed = np.random.default_rng(traffic["size_seed"])
    prompts = spread(*traffic["prompt_tokens"], n)
    budgets = fixed.permutation(spread(*traffic["output_tokens"], n))
    ramp_p = spread(*traffic["prompt_tokens"], c)
    ramp_b = fixed.permutation(spread(*traffic["ramp_output_tokens"], c))
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    ramp = rng.permutation(c)
    high = traffic["token_id_high"]
    plan = []
    for ci in range(c):
        reqs = []
        sizes = [(int(ramp_p[ramp[ci]]), int(ramp_b[ramp[ci]]))]
        sizes += [(int(prompts[order[ci * (r - 1) + k]]),
                   int(budgets[order[ci * (r - 1) + k]]))
                  for k in range(r - 1)]
        for k, (p, bud) in enumerate(sizes):
            reqs.append(Request(ci, k, rng.integers(0, high, p).tolist(),
                                bud))
        plan.append(reqs)
    return plan
