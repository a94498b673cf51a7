"""batch_fill: live slots a decode segment over the engine's slots,
averaged over the window's segments (each segment's steps see the same
slots), from the program's ``serving.batch_fill_ratio`` observations."""


def read(ctx):
    p = ctx.program
    if not p:
        return None
    a = p["t0"]["timers"].get("serving.batch_fill_ratio", {})
    b = p["t1"]["timers"].get("serving.batch_fill_ratio")
    if not b or b["count"] - a.get("count", 0) <= 0:
        return None
    return (100.0 * (b["total_s"] - a.get("total_s", 0.0))
            / (b["count"] - a.get("count", 0)))
