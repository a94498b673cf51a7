"""device_idle_pct: the share of the traced sub-window in which no
operation ran on the device (the union of its kernels, copies and
memsets, one stream), from the profiler's trace."""


def read(ctx):
    t = ctx.traced
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
