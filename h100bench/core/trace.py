"""The traced sub-window: ``torch.profiler`` over a steady stretch of the
run, the device's busy time, time by device operation, idle gaps by what
the host was doing, and device time under the harness's own ranges.

Two kinds of pass.  ``DeviceBusy`` records device activity alone, after
one step that warms the profiler up: the host records no op, so the
device's busy share is the program's and not the profiler's.
``Profiled`` records the host's ops too, which the ranges and the idle
gaps' labels need; recording them slows a busy host, so its gaps are
longer than the program's own.

Ranges (``OpRanges``) are profiler ranges that the harness puts around
calls into the program, from its own files: a per-layer metric wraps the
operation whose work it counts (``install`` in its file), and the
device time of what was launched inside the range is that operation's
time (``launched_under_ranges``).  A range records only while a traced sub-window is open; outside
it the wrapper is one flag test.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter, defaultdict

import numpy as np

PREFIX = "h100bench."
#: idle gaps shorter than this are launch jitter, not a host stall
MIN_GAP_US = 20.0
#: the gaps labelled by the host op under them, longest first
MAX_GAPS = 4000


class OpRanges:
    """Wrappers that put a profiler range around a call and, while a
    traced sub-window records, keep what ``record`` derives from each
    call (shapes, lengths) for the metric that counts its work."""

    def __init__(self):
        self.recording = False
        self.calls: dict[str, list] = defaultdict(list)

    def wrap(self, fn, op: str, record=None):
        import torch

        label = PREFIX + op
        ranges = self

        def wrapped(*args, **kwargs):
            if not ranges.recording:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
            if record is not None:
                ranges.calls[op].append(record(*args, **kwargs))
            return out

        wrapped.__wrapped__ = fn
        return wrapped


def wrap_attr(owner, attr: str, ranges: OpRanges, op: str, record=None):
    """Replace ``owner.attr`` by its wrapped self; False when ``owner``
    has no such attribute (the metric then finds nothing to read)."""
    fn = getattr(owner, attr, None)
    if fn is None:
        return False
    setattr(owner, attr, ranges.wrap(fn, op, record))
    return True


def wrap_registered(kind: str, name: str, ranges: OpRanges, op: str,
                    record=None) -> bool:
    """Wrap the kernel candidate ``(kind, name)`` of the port's registry,
    so every caller that resolves it from now on calls the wrapper."""
    import dataclasses as dc

    from deeplearning4j_tpu_torch.ops.cuda import registry

    try:
        cand = registry.get(kind, name)
    except KeyError:
        return False
    table = getattr(registry, "_REGISTRY", None)
    if table is None or table.get((kind, name)) is not cand:
        return False
    table[(kind, name)] = dc.replace(cand, fn=ranges.wrap(cand.fn, op,
                                                          record))
    return True


@dataclasses.dataclass
class TraceResult:
    window_s: float
    busy_s: float
    device_ops: list            # [(name, seconds)], most time first
    idle_gaps: list             # [(host op under the gap, seconds)]
    op_range_count: dict        # harness range -> ranges seen
    by_name_s: dict             # device op -> seconds
    #: harness range -> device seconds of what was launched inside it
    #: (``launched_under_ranges``)
    op_device_s: dict = dataclasses.field(default_factory=dict)


def _experimental_config():
    import torch

    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


class Profiled:
    """``with Profiled(ranges) as p:`` traces its body; ``p.result`` holds
    the reduction once the block ends.  The body should end in work that
    the block's exit waits for: the exit synchronises the device."""

    def __init__(self, ranges: OpRanges | None = None):
        self.ranges = ranges
        self.result: TraceResult | None = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        kw = {}
        cfg = _experimental_config()
        if cfg is not None:
            kw["experimental_config"] = cfg
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts, **kw)
        self._prof.__enter__()
        if self.ranges is not None:
            self.ranges.recording = True
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.ranges is not None:
            self.ranges.recording = False
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.result = reduce_events(self._prof.events(), wall)
            self.result.op_device_s = launched_under_ranges(self._prof)
        return False


class DeviceBusy:
    """``with DeviceBusy(steps) as d:`` traces device activity alone over
    ``steps`` steps after one warm-up step; the body calls ``d.step()``
    after launching each of its ``steps + 1`` steps.  The warm-up step
    runs with the profiler set up but not recording (a schedule's
    warm-up), and the window runs from the recording's start, the device
    idle, to the device's end of the last step.  ``d.result`` holds the
    reduction once the block ends."""

    def __init__(self, steps: int):
        self.steps = steps
        self.result: TraceResult | None = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        self._prof = profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=self.steps, repeat=1))
        self._prof.__enter__()
        self._n = 0
        self._wall = None
        return self

    def step(self) -> None:
        import torch

        if self._n in (0, self.steps) and torch.cuda.is_available():
            torch.cuda.synchronize()
        if self._n == self.steps:
            self._wall = time.perf_counter() - self._t0
        self._prof.step()
        if self._n == 0:
            self._t0 = time.perf_counter()
        self._n += 1

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            if self._n != self.steps + 1:
                raise RuntimeError(f"DeviceBusy: {self._n} steps, "
                                   f"{self.steps + 1} due")
            self.result = reduce_events(self._prof.events(), self._wall)
        return False


def _union_s(intervals: list) -> tuple[float, list]:
    """Seconds covered by ``intervals`` (µs pairs), and the merged list."""
    if not intervals:
        return 0.0, []
    intervals.sort()
    merged = [list(intervals[0])]
    for a, b in intervals[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e6, merged


def reduce_events(events, wall_s: float) -> TraceResult:
    """Busy time, device ops, idle gaps and range counts of one trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for e in events:
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith(PREFIX):
                continue
            dev.append(e)
        else:
            cpu.append(e)
    by_name: Counter = Counter()
    spans = []
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        by_name[e.name] += (b - a) / 1e6
        spans.append((a, b))
    busy_s, merged = _union_s(spans)
    op_n = Counter(e.name[len(PREFIX):] for e in cpu
                   if e.name.startswith(PREFIX))
    return TraceResult(
        window_s=wall_s, busy_s=busy_s,
        device_ops=[(n[:160], s) for n, s in by_name.most_common(10)],
        idle_gaps=_label_gaps(merged, cpu), op_range_count=dict(op_n),
        by_name_s=dict(by_name))


def _label_gaps(merged: list, cpu: list) -> list:
    """The idle stretches between device activity, longest first, each
    named by the innermost host op that covers its midpoint, summed by
    name: the ten names with the most idle seconds."""
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] - merged[i][1] >= MIN_GAP_US]
    if not gaps:
        return []
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:MAX_GAPS]
    starts = np.array([e.time_range.start for e in cpu], dtype=np.float64)
    ends = np.array([e.time_range.end for e in cpu], dtype=np.float64)
    names = [e.name for e in cpu]
    dur = ends - starts
    out: Counter = Counter()
    for a, b in gaps:
        m = (a + b) / 2
        idx = np.nonzero((starts <= m) & (ends >= m))[0] if len(starts) \
            else np.array([], dtype=np.int64)
        label = (names[idx[np.argmin(dur[idx])]][:160] if len(idx)
                 else "no host op recorded")
        out[label] += (b - a) / 1e6
    return out.most_common(10)


def _launch_call(name: str) -> bool:
    """A runtime or driver call that puts work on the device."""
    return name.startswith("cu") and any(
        w in name for w in ("Launch", "Memcpy", "Memset"))


def launched_under_ranges(prof) -> dict:
    """Device seconds of the kernels, copies and memsets launched inside
    each harness range: a device activity is matched to the runtime or
    driver call that launched it (by CUPTI's correlation id), and that
    call to the innermost harness range that held it on its thread.  This
    reads the raw Kineto events; it does not rely on the profiler's own
    linking of a kernel to the op around its launch.  Empty where the
    events lack a field this needs."""
    try:
        return _launched(prof.profiler.kineto_results.events())
    except AttributeError:
        return {}


def _launched(raw) -> dict:
    ranges = defaultdict(list)          # thread -> [(start, end, op)]
    launches = {}                       # correlation -> (thread, start)
    device = []                         # (correlation, seconds)
    for e in raw:
        name = e.name()
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device:
            if not name.startswith(PREFIX):
                device.append((e.correlation_id(), e.duration_ns() / 1e9))
        elif name.startswith(PREFIX):
            ranges[e.start_thread_id()].append(
                (e.start_ns(), e.end_ns(), name[len(PREFIX):]))
        elif _launch_call(name):
            launches[e.correlation_id()] = (e.start_thread_id(),
                                            e.start_ns())
    out: Counter = Counter()
    for corr, seconds in device:
        launch = launches.get(corr)
        if launch is None:
            continue
        tid, t = launch
        inner = [(b - a, op) for a, b, op in ranges.get(tid, ())
                 if a <= t <= b]
        if inner:
            out[min(inner)[1]] += seconds
    return dict(out)
