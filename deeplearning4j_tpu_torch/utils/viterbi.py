"""Viterbi sequence decoder.

Port of ``deeplearning4j_tpu/utils/viterbi.py`` (capability match of
``util/Viterbi.java:15,47-57``): the most likely label sequence given
per-step emission scores and a transition matrix.  The recursion runs on
the device, T-1 steps of an ``(S, S)`` add, ``max`` and ``argmax`` over
the previous state; the backpointers are stacked on the device and
copied to the host once, and the traceback is a host loop, as in the
reference.  Scores are float32, as the reference casts them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def viterbi_decode(emissions, transitions, initial=None, device=None):
    """emissions: (T, S) log scores; transitions: (S, S) log p(j <- i).

    Returns (path indices (T,), best log score).  On ties the first state
    wins, as with ``jnp.argmax``."""
    dev = resolve_device(device)
    emissions = torch.as_tensor(emissions, dtype=torch.float32, device=dev)
    transitions = torch.as_tensor(transitions, dtype=torch.float32,
                                  device=dev)
    T, S = emissions.shape
    init = (torch.zeros((S,), dtype=torch.float32, device=dev)
            if initial is None
            else torch.as_tensor(initial, dtype=torch.float32, device=dev))
    scores = init + emissions[0]
    backptrs = []
    for t in range(1, T):
        step = scores[:, None] + transitions + emissions[t][None, :]
        # torch.max over a dim returns the first maximal index
        scores, best_prev = torch.max(step, dim=0)
        backptrs.append(best_prev)
    bp = (torch.stack(backptrs).cpu().numpy() if backptrs
          else np.zeros((0, S), np.int64))
    final = scores.cpu().numpy()
    path = np.zeros(T, np.int64)
    path[-1] = int(np.argmax(final))
    for t in range(T - 2, -1, -1):
        path[t] = bp[t, path[t + 1]]
    return path, float(np.max(final))


class Viterbi:
    """Binary-label decoder over window predictions (the reference decodes
    word-window label sequences with a fixed switching penalty)."""

    def __init__(self, possible_labels, transition_prob: float = 0.95, *,
                 device=None):
        self.labels = list(possible_labels)
        self.device = resolve_device(device)
        s = len(self.labels)
        stay = np.log(transition_prob)
        switch = np.log(max(1e-12, (1 - transition_prob) / max(1, s - 1)))
        self.transitions = np.full((s, s), switch)
        np.fill_diagonal(self.transitions, stay)

    def decode(self, emission_probs) -> list:
        em = np.log(np.maximum(np.asarray(emission_probs, np.float64), 1e-12))
        path, _ = viterbi_decode(em, self.transitions, device=self.device)
        return [self.labels[i] for i in path]
