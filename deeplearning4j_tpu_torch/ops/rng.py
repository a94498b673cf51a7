"""Random streams over an explicit ``torch.Generator`` on an explicit
device.

Port of ``deeplearning4j_tpu/ops/rng.py``.  The reference splits
threefry keys; torch cannot reproduce those streams, so the port's
stream is a ``torch.Generator``.  :meth:`RngStream.next_key` hands out a
fresh generator whose seed comes from a splitmix64 walk on the host, so
splitting never reads the device.
"""

from __future__ import annotations

import torch

from ..device import resolve_device

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def _generator(seed: int, device=None) -> torch.Generator:
    """A generator on ``device`` (default ``cuda``) seeded ``seed``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed) & ((1 << 63) - 1))


class RngStream:
    """One generator object for host orchestration (weight init, data
    shuffles): draws advance ``gen``; :meth:`next_key` and :meth:`split`
    hand out independent generators on the same device."""

    def __init__(self, seed_or_key, *, device=None):
        if isinstance(seed_or_key, torch.Generator):
            self.gen = seed_or_key
            self._state = seed_or_key.initial_seed()
        else:
            self.gen = _generator(seed_or_key, device)
            self._state = int(seed_or_key)
        self.device = self.gen.device

    def next_key(self) -> torch.Generator:
        self._state = _splitmix64(self._state)
        return _generator(self._state, self.device)

    def split(self, n: int) -> list:
        return [self.next_key() for _ in range(n)]

    def uniform(self, shape=(), minval=0.0, maxval=1.0, dtype=torch.float32):
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=dtype)
        return minval + (maxval - minval) * u

    def normal(self, shape=(), dtype=torch.float32):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=dtype)

    def permutation(self, n: int):
        return torch.randperm(n, generator=self.gen, device=self.device)


def key_for(seed: int | None, default: int = 123, *, device=None):
    """A generator from an optional seed (``default`` when None)."""
    return _generator(default if seed is None else seed, device)
