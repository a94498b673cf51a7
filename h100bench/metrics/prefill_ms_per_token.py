"""prefill_ms_per_token: the engine's prefill time over the window per
prompt token it prefilled.

Time: the program's ``serving.prefill`` timer (host seconds around each
admission's prefill; it ends without a device fence, so it times the
enqueue, near the true time only while prefill is host-bound), its total
at the window's close less its total at the open.  Tokens: counted by a
wrapper the harness puts around the engine's ``_prefill``, for the
prefills that end inside the window (each runs ``prompt[:-1]`` less the
positions a prefix cache held).
"""

KEY = "prefill_tokens"


def install(ctx):
    ctx.counts[KEY] = 0

    def hook(engine):
        fn = getattr(engine, "_prefill", None)
        if fn is None:
            return

        def prefill(params, slot, req, cached_len=0, *a, **kw):
            out = fn(params, slot, req, cached_len, *a, **kw)
            if ctx.in_window:
                ctx.counts[KEY] += len(req.prompt) - 1 - cached_len
            return out

        engine._prefill = prefill

    ctx.engine_hooks.append(hook)


def read(ctx):
    p = ctx.program
    tokens = ctx.counts.get(KEY, 0)
    if not p or tokens <= 0:
        return None
    t0 = p["t0"]["timers"].get("serving.prefill", {}).get("total_s", 0.0)
    t1 = p["t1"]["timers"].get("serving.prefill", {}).get("total_s")
    if t1 is None:
        return None
    return 1000.0 * (t1 - t0) / tokens
