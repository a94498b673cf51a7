"""LSTM sequence model: training, sampling, and beam-search decoding.

Port of ``deeplearning4j_tpu/models/lstm.py`` (capability match of
``models/classifiers/lstm/LSTM.java``, char-rnn style): train
x->next-token with the concatenated-gate LSTM of ``nn.layers`` (BPTT by
autodiff through the time loop), then decode with temperature sampling
or beam search.  The generators are explicit: ``init`` draws from a
``torch.Generator`` (by default a CPU one seeded ``conf.seed``, so a CPU
and a GPU model start from the same values), and ``sample`` draws from
numpy's ``default_rng(seed)`` as the reference does, so the same
log-probabilities give the same tokens in both packages.  Decoding runs
one step at a time on the model's device, reading each step's
log-probabilities to the host as the reference does.  Training reads one
loss an epoch to the host, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..nn.conf import LayerKind, NeuralNetConfiguration
from ..nn.layers import LSTM as LSTMLayer


class LSTMSequenceModel:
    def __init__(self, vocab_size: int, hidden_size: int = 128, *,
                 lr: float = 0.1, seed: int = 0, device=None):
        self.conf = NeuralNetConfiguration(
            kind=LayerKind.LSTM, n_in=vocab_size, n_out=vocab_size,
            hidden_size=hidden_size, activation="softmax", lr=lr, seed=seed)
        self.layer = LSTMLayer(self.conf)
        self.device = resolve_device(device)
        self.params = None
        self._step = None

    def init(self, gen: torch.Generator | None = None):
        if gen is None:
            gen = torch.Generator().manual_seed(self.conf.seed)
        self.params = {k: v.to(self.device)
                       for k, v in self.layer.init(gen).items()}
        return self.params

    def _one_hot(self, tokens) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(tokens), device=self.device).long()
        return F.one_hot(t, self.conf.n_in).to(torch.float32)

    # ------------------------------------------------------------------ train
    def fit_sequence(self, tokens: np.ndarray, epochs: int = 100) -> list[float]:
        """Next-token training on one index sequence (char-rnn style)."""
        if self.params is None:
            self.init()
        x = self._one_hot(tokens[:-1])
        y = self._one_hot(tokens[1:])
        if self._step is None:
            lr = self.conf.lr
            loss_fn = self.layer.loss

            def step(params, x, y):
                # plain autograd: over hundreds of tiny time steps it
                # costs a quarter of torch.func's per-op overhead
                leaves = {k: p.detach().requires_grad_(True)
                          for k, p in params.items()}
                loss = loss_fn(leaves, x, y)
                g = dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))))
                with torch.no_grad():
                    return ({k: p - lr * g[k] for k, p in leaves.items()},
                            loss.detach())

            self._step = step
        losses = []
        for _ in range(epochs):
            self.params, loss = self._step(self.params, x, y)
            losses.append(loss)   # stays on the device; read once below
        return [float(v) for v in losses]

    # ------------------------------------------------------------------ decode
    def _logp(self, h) -> np.ndarray:
        logits = h @ self.params["decoderweights"] + self.params["decoderbias"]
        return torch.log_softmax(logits, dim=-1).cpu().numpy()

    @torch.no_grad()
    def _step_logits(self, carry, token_id: int):
        x_t = F.one_hot(torch.tensor(int(token_id), device=self.device),
                        self.conf.n_in).to(torch.float32)
        carry, h = self.layer._step(self.params, carry, x_t)
        return carry, self._logp(h)

    def _init_carry(self):
        d = self.conf.hidden_size or self.conf.n_out
        zero = torch.zeros((d,), dtype=torch.float32, device=self.device)
        return (zero, zero)

    @torch.no_grad()
    def _prime(self, prime: list[int]):
        """Carry + log-probs after consuming ``prime`` (possibly empty: the
        zero hidden state's decoder distribution seeds generation)."""
        carry = self._init_carry()
        logp = self._logp(carry[0])
        for t in prime:
            carry, logp = self._step_logits(carry, t)
        return carry, logp

    def sample(self, prime: list[int], length: int, temperature: float = 1.0,
               seed: int = 0) -> list[int]:
        """Temperature sampling continuation of ``prime``."""
        rng = np.random.default_rng(seed)
        carry, logp = self._prime(prime)
        out = list(prime)
        for _ in range(length):
            p = np.exp(logp / temperature)
            p /= p.sum()
            t = int(rng.choice(len(p), p=p))
            out.append(t)
            carry, logp = self._step_logits(carry, t)
        return out

    def beam_search(self, prime: list[int], length: int, beam_width: int = 5
                    ) -> tuple[list[int], float]:
        """Highest-log-likelihood continuation (``LSTM.java BeamSearch``).

        Returns (token sequence, total log prob)."""
        carry, logp = self._prime(prime)
        beams = [(0.0, list(prime), carry, logp)]
        for _ in range(length):
            candidates = []
            for score, seq, c, lp in beams:
                top = np.argsort(-lp)[:beam_width]
                for t in top:
                    candidates.append((score + float(lp[t]), seq + [int(t)], c, int(t)))
            candidates.sort(key=lambda s: -s[0])
            new_beams = []
            for score, seq, c, t in candidates[:beam_width]:
                c2, lp2 = self._step_logits(c, t)
                new_beams.append((score, seq, c2, lp2))
            beams = new_beams
        best = max(beams, key=lambda b: b[0])
        return best[1], best[0]

    def predict_next(self, prime: list[int]) -> int:
        carry, logp = self._prime(prime)
        return int(np.argmax(logp))
