"""train_fwd_ms: the device time of the LM train step's forward
(``loss_of``, the ``lm.forward`` span), in ms a step of the window.

The six span metrics read the program's device-timed spans
(``deeplearning4j_tpu_torch.observability.tracing``): a window step is
an ``lm.step`` span whose host start lies inside the timed window, and a
metric sums ``device_ms`` of its spans that carry a window step's trace
id, over the count of window steps.  A span's ``device_ms`` comes from
two CUDA events on the step's stream (on the CPU, in a rehearsal, its
host duration).  ``per_step_ms`` is the reader the other five call; it
returns None where the program records no such span.
"""

SPANS = ("lm.forward",)


def per_step_ms(ctx, names) -> float | None:
    """Device ms a window step of the spans ``names``, or None."""
    w = ctx.window
    if "t0" not in w:
        return None
    try:
        from deeplearning4j_tpu_torch.observability import tracing

        tracing.TRACER.drain()
        a = tracing.host_ts_us(w["t0"])
        b = tracing.host_ts_us(w["t0"] + w["seconds"])
    except (ImportError, AttributeError):
        return None
    events = tracing.TRACER.to_chrome_trace()["traceEvents"]
    steps = [e["args"]["trace_id"] for e in events
             if e["name"] == "lm.step" and a <= e["ts"] <= b]
    window = set(steps)
    ms = [e["args"]["device_ms"] for e in events
          if e["name"] in names and "device_ms" in e["args"]
          and e["args"].get("trace_id") in window]
    if not steps or not ms:
        return None
    return sum(ms) / len(steps)


def read(ctx):
    return per_step_ms(ctx, SPANS)
