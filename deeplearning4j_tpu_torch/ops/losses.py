"""Losses of the port that the training path calls.

Port of the part of ``deeplearning4j_tpu/ops/losses.py`` that
``lm_head_loss`` reaches: :func:`blocked_token_xent`.  The JAX package
picks its blocked-xent backend once at import (the Pallas kernel where it
imports); the port always has its kernel, so this is the
``ops.cuda.xent`` wrapper (its plain version for CPU tensors).
"""

from __future__ import annotations

from .cuda.xent import blocked_cross_entropy


def blocked_token_xent(h, head, targets, weights=None, **kw):
    """Weighted SUM of per-token cross entropy of (N, D) hiddens against a
    (D, V) head, streamed tile by tile: the full logits never exist on
    the GPU.  Any N and V."""
    return blocked_cross_entropy(h, head, targets, weights, **kw)
