"""Loss functions.

Port of ``deeplearning4j_tpu/ops/losses.py``: every ``LossFunction`` of
the reference, ``get`` and ``score``.  All take ``(labels, output)`` with
``output`` already activated (softmax probabilities for MCXENT) and
return the mean over examples, except ``blocked_mcxent``, which takes raw
logits or an ``(h, head)`` pair.  The pair goes through the blocked
cross-entropy kernel (``ops.cuda.xent``; its plain version for CPU
tensors), so the (N, V) logits never exist on the GPU.
"""

from __future__ import annotations

import enum
from typing import Callable

import torch

from .cuda.xent import blocked_cross_entropy

_EPS = 1e-7


class LossFunction(str, enum.Enum):
    """Names mirror the reference's LossFunctions.LossFunction enum."""

    MSE = "mse"
    EXPLL = "expll"                 # exponential log likelihood (Poisson-like)
    XENT = "xent"                   # elementwise binary cross entropy
    MCXENT = "mcxent"               # multiclass cross entropy (softmax output)
    RMSE_XENT = "rmse_xent"         # sqrt of squared-error (reference quirk)
    SQUARED_LOSS = "squared_loss"   # summed squared error (no 1/2)
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"

    # --- additions beyond the v0 reference (needed by modern heads) ---
    COSINE_PROXIMITY = "cosine_proximity"
    HINGE = "hinge"
    L1 = "l1"
    BLOCKED_MCXENT = "blocked_mcxent"   # streaming xent — takes RAW logits
    #                                     (or an (h, head) pair), not
    #                                     softmax output; see blocked_mcxent


def _clip(p):
    return torch.clamp(p, _EPS, 1.0 - _EPS)


def mse(labels, output):
    return torch.mean(torch.sum((labels - output) ** 2, dim=-1)) / 2.0


def squared_loss(labels, output):
    return torch.mean(torch.sum((labels - output) ** 2, dim=-1))


def rmse_xent(labels, output):
    return torch.mean(torch.sqrt(torch.sum((labels - output) ** 2, dim=-1)
                                 + _EPS))


def xent(labels, output):
    p = _clip(output)
    return -torch.mean(torch.sum(labels * torch.log(p)
                                 + (1 - labels) * torch.log1p(-p), dim=-1))


def mcxent(labels, output):
    return -torch.mean(torch.sum(labels * torch.log(_clip(output)), dim=-1))


def expll(labels, output):
    p = torch.clamp(output, min=_EPS)
    return torch.mean(torch.sum(p - labels * torch.log(p), dim=-1))


def negativeloglikelihood(labels, output):
    return -torch.mean(torch.sum(labels * torch.log(_clip(output)), dim=-1))


def reconstruction_crossentropy(labels, output):
    return xent(labels, output)


def cosine_proximity(labels, output):
    ln = labels / (torch.linalg.vector_norm(labels, dim=-1, keepdim=True)
                   + _EPS)
    on = output / (torch.linalg.vector_norm(output, dim=-1, keepdim=True)
                   + _EPS)
    return -torch.mean(torch.sum(ln * on, dim=-1))


def hinge(labels, output):
    # labels in {0,1} one-hot or {-1,1}
    y = torch.where(labels > 0, 1.0, -1.0).to(output.dtype)
    return torch.mean(torch.sum(torch.clamp(1.0 - y * output, min=0.0),
                                dim=-1))


def l1(labels, output):
    return torch.mean(torch.sum(torch.abs(labels - output), dim=-1))


# --------------------------------------------------------- blocked xent tier

def blocked_token_xent(h, head, targets, weights=None, **kw):
    """Weighted SUM of per-token cross entropy of (N, D) hiddens against
    a (D, V) head, streamed tile by tile: the full logits never exist on
    the GPU.  Any N and V."""
    return blocked_cross_entropy(h, head, targets, weights, **kw)


def blocked_mcxent(labels, output):
    """Dispatch-table face of the blocked xent tier.

    Unlike every other entry, ``output`` is NOT softmax probabilities:
    pass either raw logits (N, C), computed stably from the lse, or an
    ``(hiddens, head)`` tuple, which runs the blocked cross-entropy
    kernel so the (N, V) logits never exist.  ``labels`` are one-hot rows
    either way; returns the mean over examples."""
    if isinstance(output, tuple):
        h, head = output
        targets = torch.argmax(labels, dim=-1)
        return blocked_token_xent(h, head, targets) / labels.shape[0]
    logits = output.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.sum(labels * logits, dim=-1)
    return torch.mean(lse - gold)


_FNS: dict[LossFunction, Callable] = {
    LossFunction.MSE: mse,
    LossFunction.EXPLL: expll,
    LossFunction.XENT: xent,
    LossFunction.MCXENT: mcxent,
    LossFunction.RMSE_XENT: rmse_xent,
    LossFunction.SQUARED_LOSS: squared_loss,
    LossFunction.NEGATIVELOGLIKELIHOOD: negativeloglikelihood,
    LossFunction.RECONSTRUCTION_CROSSENTROPY: reconstruction_crossentropy,
    LossFunction.COSINE_PROXIMITY: cosine_proximity,
    LossFunction.HINGE: hinge,
    LossFunction.L1: l1,
    LossFunction.BLOCKED_MCXENT: blocked_mcxent,
}


def get(loss: LossFunction | str) -> Callable:
    return _FNS[LossFunction(loss)]


def score(loss: LossFunction | str, labels, output):
    return get(loss)(labels, output)
