"""A kernel's share of its roofline, from the harness's ranges.

The least time of each call the traced sub-window recorded, computed
from the operation's work at the call's shapes (the metric's own
``work``), over the device time of the kernels launched inside the
calls' ranges.  A share reads the operation's work, whatever implements
it, so a kernel replaced or fused later keeps the same yardstick.
"""

from __future__ import annotations

from . import peaks

#: calls whose range a trace's end can cut: one a thread that calls
MAX_CUT = 2


def share_pct(ctx, op: str, work) -> float | None:
    """``100 * sum(least time) / device time`` of ``op``'s calls, or None
    where the trace holds none (or holds ranges the calls do not match)."""
    t = ctx.traced
    if t is None or ctx.ranges is None:
        return None
    calls = ctx.ranges.calls.get(op, [])
    device_s = t.op_device_s.get(op, 0.0)
    n = t.op_range_count.get(op, 0)
    # a call of another thread still inside its range when the trace
    # stopped is kept (it ends later) but its range is not: the last calls
    if not n or device_s <= 0 or not 0 <= len(calls) - n <= MAX_CUT:
        return None
    calls = calls[:n]
    least = 0.0
    for call in calls:
        flops, nbytes, dtype = work(call)
        least += peaks.least_time_s(flops, nbytes,
                                    peaks.matmul_flops_rate(ctx.peaks, dtype),
                                    ctx.peaks)
    return 100.0 * least / device_s
