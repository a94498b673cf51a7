"""decode_step_ms: the engine's decode step time over the whole window:
the program's ``serving.decode_step`` timer (each segment of steps timed
from its launch to the host copy of its tokens, a fence, and split over
its steps), its seconds over its steps between the window's open and
close; not a median."""


def read(ctx):
    p = ctx.program
    if not p:
        return None
    a = p["t0"]["timers"].get("serving.decode_step", {})
    b = p["t1"]["timers"].get("serving.decode_step")
    if not b or b["count"] - a.get("count", 0) <= 0:
        return None
    return (1000.0 * (b["total_s"] - a.get("total_s", 0.0))
            / (b["count"] - a.get("count", 0)))
