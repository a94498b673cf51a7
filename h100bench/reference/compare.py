"""The comparisons that decide ``correct``, against the plain reference.

Training (three steps from the same weights on the same batches):

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the first gradient as the optimizer got it, by the worst
  leaf: ``|‖g_p‖ - ‖g_r‖| / max(‖g_r‖, median leaf ‖g_r‖)``;
- ``change``: the parameters' change after the three steps, by the worst
  leaf, the same way, over the leaves whose reference gradient is at least
  a thousandth of the median leaf's (a leaf with none moves by round-off
  alone under Adam).

Serving: ``token_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position, over a sample of the
finished requests, teacher-forced through the reference.
"""

from __future__ import annotations

import statistics

import torch

from . import lm

#: leaves whose reference gradient norm is below this share of the median
#: leaf's are left out of ``change``
NEGLIGIBLE_GRAD = 1e-3


def norms(tree_or_leaves: dict) -> dict:
    """``{leaf: ‖x‖}`` as floats, read in one transfer."""
    flat = (lm.leaves(tree_or_leaves) if "layers" in tree_or_leaves
            else tree_or_leaves)
    keys = list(flat)
    vals = torch.stack([torch.linalg.vector_norm(flat[k].float())
                        for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def worst_leaf(got: dict, want: dict, keys=None) -> tuple[float, str]:
    """The largest ``|got - want| / max(want, median want)`` and its leaf."""
    keys = list(want) if keys is None else list(keys)
    med = statistics.median(want[k] for k in want)
    worst, where = 0.0, ""
    for k in keys:
        gap = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        if gap > worst:
            worst, where = gap, k
    return worst, where


def train_readings(prog: dict, ref: dict) -> dict:
    """``{"loss", "grad", "change"}`` of a record against the reference's.
    A record: ``losses`` (the steps' losses), ``grad_norms`` and
    ``change_norms`` (per leaf)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    grad, grad_leaf = worst_leaf(prog["grad_norms"], ref["grad_norms"])
    med = statistics.median(ref["grad_norms"].values())
    moving = [k for k, v in ref["grad_norms"].items()
              if v >= NEGLIGIBLE_GRAD * med]
    change, change_leaf = worst_leaf(prog["change_norms"],
                                     ref["change_norms"], moving)
    return {"loss": loss, "grad": grad, "change": change,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": sorted(set(ref["grad_norms"]) - set(moving))}


def reference_train(params0: dict, batches: list, model: dict, opt: dict,
                    steps: int, rows: int, quant: str | None = None,
                    half_batch: bool = False) -> dict:
    """The reference's record of ``steps`` steps from ``params0``.
    ``half_batch`` plants the fault of a step that leaves out half of
    its rows (the mean taken over the rest)."""
    with lm.exact_float32():
        adam = lm.AdamW(params0, opt)
        params = params0
        losses, grad_norms = [], None
        for i in range(steps):
            toks, tgts = batches[i]
            if half_batch:
                toks, tgts = toks[:toks.shape[0] // 2], tgts[:tgts.shape[0] // 2]
            loss, g = lm.grads(params, toks, tgts, model, rows, quant)
            losses.append(loss)
            if i == 0:
                grad_norms = norms(g)
            params = adam.update(params, g)
            del g
        p0 = lm.leaves(params0)
        change = {k: v - p0[k] for k, v in lm.leaves(params).items()}
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": norms(change)}


def served_gaps(params: dict, model: dict, prompt: list, served: list,
                device, quant: str | None = None) -> list:
    """Per served token, how far its reference logit lies below the
    reference's best at its position.  With ``quant``, the gap of the token
    that the lower-precision reference puts first there (the control)."""
    seq = torch.tensor(prompt + served[:-1], dtype=torch.long,
                       device=device)[None]
    p = len(prompt)
    with lm.exact_float32(), torch.no_grad():
        ref = lm.logits(params, seq, model)[0, p - 1:]
        if quant is None:
            pick = torch.tensor(served, dtype=torch.long, device=device)
        else:
            pick = lm.logits(params, seq, model, quant)[0, p - 1:].argmax(-1)
        gap = ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]
    return gap.cpu().tolist()
