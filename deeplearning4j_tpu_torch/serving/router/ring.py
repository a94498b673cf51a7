"""Consistent-hash ring with virtual nodes.

Port of ``deeplearning4j_tpu/serving/router/ring.py``; its hashes are the
reference's byte for byte (blake2b, 8 bytes, of ``"{name}#{i}"``), so a
key picks the same node in both packages.  Every replica owns ``vnodes``
points on a 64-bit circle; a key hashes to a point and walks clockwise to
the first node.  Adding or removing one replica remaps only ~1/N of the
keyspace, so prefix affinity survives elastic membership.

Quarantine is not a ring operation: ``walk(key)`` yields every distinct
node in clockwise order and the caller filters unhealthy ones, so a
quarantined node's segment drains to its successors and snaps back on
re-admission.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterator


def _point(data: str) -> int:
    """64-bit position on the circle for an arbitrary string."""
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Static membership + deterministic clockwise walk.

    Not thread-safe by itself: the router mutates membership only at
    construction time; a future elastic tier would swap whole rings
    atomically rather than locking per-lookup.
    """

    def __init__(self, names: list[str] | None = None, vnodes: int = 64):
        if vnodes <= 0:
            raise ValueError("vnodes must be positive")
        self.vnodes = vnodes
        self._names: set[str] = set()
        self._points: list[tuple[int, str]] = []  # sorted (position, name)
        for name in names or ():
            self.add(name)

    def add(self, name: str) -> None:
        if name in self._names:
            raise ValueError(f"replica {name!r} already on the ring")
        self._names.add(name)
        for i in range(self.vnodes):
            bisect.insort(self._points, (_point(f"{name}#{i}"), name))

    def remove(self, name: str) -> None:
        if name not in self._names:
            raise KeyError(name)
        self._names.discard(name)
        self._points = [p for p in self._points if p[1] != name]

    def nodes(self) -> list[str]:
        return sorted(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def walk(self, key: str) -> Iterator[str]:
        """Every distinct node, clockwise from ``key``'s position.  The
        first yield is the key's owner; successors are its spillover /
        drain order.  Deterministic for a fixed membership."""
        if not self._points:
            return
        start = bisect.bisect_left(self._points, (_point(key), ""))
        seen: set[str] = set()
        n = len(self._points)
        for off in range(n):
            name = self._points[(start + off) % n][1]
            if name not in seen:
                seen.add(name)
                yield name

    def primary(self, key: str) -> str | None:
        """The key's owner (first walk entry), or None on an empty ring."""
        for name in self.walk(key):
            return name
        return None
