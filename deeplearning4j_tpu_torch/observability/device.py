"""Device-memory gauges.

Port of ``deeplearning4j_tpu/observability/device.py``.
:func:`sample_device_memory` publishes each visible GPU's
``torch.cuda.memory_stats`` into the registry; without CUDA it is a no-op
gauge (``device.memory_stats_supported`` = 0), so instrumented paths call
it unconditionally.  :func:`sample_state_bytes` gauges the bytes the
parameter and optimizer-state trees hold on each device (each rank, in
a multi-rank run), from tensor metadata only (no sync, no transfer), at
trainer init and after every restore.
"""

from __future__ import annotations

import torch

from . import core
from .metrics import METRICS, MetricsRegistry
from ..utils.tree_math import tree_leaves

# the reference's key names, from the caching allocator's statistics
_KEYS = (("bytes_in_use", "allocated_bytes.all.current"),
         ("peak_bytes_in_use", "allocated_bytes.all.peak"),
         ("bytes_reserved", "reserved_bytes.all.current"))


def sample_device_memory(registry: MetricsRegistry = METRICS) -> int:
    """Gauge per-device memory stats; returns how many devices reported.

    Publishes ``device.<i>.bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_reserved`` and ``bytes_limit`` (the card's total memory).
    Without CUDA this degrades to a no-op gauge, and no exception ever
    escapes."""
    if not core.enabled():
        return 0
    reported = 0
    try:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception:
        n = 0
    for i in range(n):
        try:
            stats = torch.cuda.memory_stats(i)
            prefix = f"device.{i}."
            for name, key in _KEYS:
                if key in stats:
                    registry.gauge(prefix + name, float(stats[key]))
            registry.gauge(prefix + "bytes_limit",
                           float(torch.cuda.get_device_properties(i)
                                 .total_memory))
        except Exception:
            continue
        reported += 1
    registry.gauge("device.memory_stats_supported", float(reported))
    return reported


def _bytes_by_device(tree) -> dict[str, int]:
    """Bytes held by a tree's tensors, by device, from metadata only."""
    out: dict[str, int] = {}
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf):
            d = leaf.device
            key = f"{d.type}{d.index if d.index is not None else 0}"
            out[key] = out.get(key, 0) + leaf.numel() * leaf.element_size()
    return out


def _rank_key() -> str | None:
    """This process's global rank, as a device id, when a process group
    spans several ranks (a rank is the reference's device there)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return str(dist.get_rank())
    return None


def sample_state_bytes(params, tstate,
                       registry: MetricsRegistry = METRICS) -> int:
    """Gauge ``train.params_bytes.device.<dev>`` and
    ``train.opt_state_bytes.device.<dev>``; returns the devices reported.
    ``<dev>`` is the global rank when a process group spans several ranks
    (each rank gauges what it holds: its chunks under ZeRO, the ~1/ndp
    shrink), else the device (``cuda0``, ``cpu0``)."""
    if not core.enabled():
        return 0
    rank = _rank_key()
    seen: set[str] = set()
    for name, tree in (("train.params_bytes", params),
                       ("train.opt_state_bytes", tstate)):
        by_dev = _bytes_by_device(tree)
        if rank is not None:
            by_dev = {rank: sum(by_dev.values())}
        for dev, nbytes in by_dev.items():
            registry.gauge(f"{name}.device.{dev}", float(nbytes))
            seen.add(dev)
    return len(seen)
