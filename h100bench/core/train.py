"""The training driver: ``TransformerLM.build_train_step``'s step, back
to back, on batches made from the seed ahead of time.

Set-up builds one step with its model and optimizer state, drives it
from the seed through the cell's ``check_steps`` first steps (on distinct
batches, through the window's own call) and hands that same state to the
window.  What those steps did is recorded on the way: each loss, the
first gradient as the optimizer got it (its first moment after one step
over ``1 - b1``) and the parameters' change after the last, per leaf.
Once the window has closed and the program's state is freed, the plain
reference runs the same steps from the same weights on the same batches
and :mod:`..reference.compare` decides ``correct``.
"""

from __future__ import annotations

import dataclasses
import math
import time

from ..reference import compare, lm
from . import traffic as gen
from . import weights
from .model import port_config
from .trace import DeviceBusy, Profiled


def sync(ctx) -> None:
    import torch

    if ctx.on_card:
        torch.cuda.synchronize()


def _first_moment(state, params: dict):
    """The first tree in the optimizer state laid out as ``params``: Adam's
    first moment (it precedes the second in the port's state)."""
    want = {k: tuple(v.shape) for k, v in lm.leaves(params).items()}
    if isinstance(state, dict) and "layers" in state:
        try:
            got = {k: tuple(v.shape) for k, v in lm.leaves(state).items()}
        except (AttributeError, TypeError):
            got = None
        if got == want:
            return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _first_moment(s, params)
            if found is not None:
                return found
    return None


def build(ctx, seed: int):
    """The program's step, model state and batches for ``seed``."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.optimize import transforms as TT

    s = ctx.settings
    cfg = port_config(ctx.model, s, ttr, torch)
    o = s["optimizer"]
    tx = TT.adamw(TT.warmup_cosine(o["lr"], o["warmup_steps"],
                                   o["total_steps"]),
                  weight_decay=o["weight_decay"], b1=o["b1"], b2=o["b2"],
                  eps=o["eps"])
    model = ttr.TransformerLM(cfg, device=ctx.device)
    params = weights.make(ctx.model, seed, ctx.device)
    opt = model.init_opt(params, tx)
    step = model.build_train_step(tx)
    if ctx.ranges is not None:
        step = ctx.ranges.wrap(step, "train_step")
    batches = gen.train_batches(ctx.cell.traffic, ctx.model["vocab_size"],
                                seed, ctx.device)
    return {"model": model, "step": step, "params": params, "opt": opt,
            "batches": batches}


def check_steps(ctx, st: dict, seed: int) -> dict:
    """The set-up's first steps through the window's call; returns the
    program's record of them and leaves the state after them in ``st``."""
    import torch

    n = ctx.cell.traffic["check_steps"]
    b1 = ctx.settings["optimizer"]["b1"]
    step, batches = st["step"], st["batches"]
    params, opt = st["params"], st["opt"]
    losses, grad_norms = [], None
    for i in range(n):
        params, opt, loss = step(params, opt, *batches[i])
        losses.append(loss)
        if i == 0:
            mu = _first_moment(opt, params)
            grad_norms = (None if mu is None else
                          {k: v / (1.0 - b1)
                           for k, v in compare.norms(mu).items()})
    p0 = lm.leaves(weights.make(ctx.model, seed, ctx.device))
    change = compare.norms({k: v.float() - p0[k]
                            for k, v in lm.leaves(params).items()})
    del p0
    st["params"], st["opt"] = params, opt
    return {"losses": torch.stack(losses).float().cpu().tolist(),
            "grad_norms": grad_norms, "change_norms": change}


def window(ctx, st: dict) -> dict:
    """Steps back to back for ``ctx.seconds``; the rate is every token of
    every step over the whole window, which ends once the device is done."""
    import torch

    tr = ctx.cell.traffic
    step, batches = st["step"], st["batches"]
    params, opt = st["params"], st["opt"]
    first = tr["check_steps"]
    losses, k = [], 0
    sync(ctx)
    t0 = time.perf_counter()
    ctx.in_window = True
    while True:
        params, opt, loss = step(params, opt,
                                 *batches[(first + k) % len(batches)])
        losses.append(loss)
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(ctx)
    t1 = time.perf_counter()
    ctx.in_window = False
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    st["params"], st["opt"] = params, opt
    st["next"] = first + k
    return {"t0": t0, "seconds": t1 - t0, "steps": k,
            "tokens": k * tr["batch"] * tr["seq"], "seq": tr["seq"],
            "finite": finite}


def traced_steps(ctx, st: dict) -> None:
    """Whole steps under the profiler, after the window: ``idle_steps``
    with device activity alone, for the busy share and the time by
    device operation, then ``trace_steps`` with the host's ops, for the
    ranges and the idle gaps' labels."""
    tr = ctx.cell.traffic
    step, batches = st["step"], st["batches"]
    params, opt = st["params"], st["opt"]
    k = st["next"]
    with DeviceBusy(tr["idle_steps"]) as d:
        for _ in range(tr["idle_steps"] + 1):
            params, opt, _ = step(params, opt, *batches[k % len(batches)])
            k += 1
            d.step()
    with Profiled(ctx.ranges) as p:
        for _ in range(tr["trace_steps"]):
            params, opt, _ = step(params, opt, *batches[k % len(batches)])
            k += 1
    st["params"], st["opt"] = params, opt
    ctx.traced = dataclasses.replace(
        p.result, window_s=d.result.window_s, busy_s=d.result.busy_s,
        device_ops=d.result.device_ops, by_name_s=d.result.by_name_s)


def reference_record(ctx, seed: int, batches: list, quant=None,
                     half_batch: bool = False) -> dict:
    tr = ctx.cell.traffic
    p0 = weights.make(ctx.model, seed, ctx.device)
    return compare.reference_train(p0, batches[:tr["check_steps"]],
                                   ctx.model, ctx.settings["optimizer"],
                                   tr["check_steps"], tr["reference_rows"],
                                   quant=quant, half_batch=half_batch)


def run(ctx, setup_clock) -> dict:
    import torch

    t_in = setup_clock()
    st = build(ctx, ctx.seed)
    t_built = setup_clock()
    record = check_steps(ctx, st, ctx.seed)
    setup_s = setup_clock()
    phases = {"start_to_driver": t_in, "build": t_built - t_in,
              "check_steps": setup_s - t_built}
    win = window(ctx, st)
    if ctx.trace:
        traced_steps(ctx, st)
    if ctx.on_card:
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
    ctx.window = win
    batches = st["batches"]
    st.clear()
    if ctx.on_card:
        torch.cuda.empty_cache()
    ref = reference_record(ctx, ctx.seed, batches)
    complete = record["grad_norms"] is not None
    readings = (compare.train_readings(record, ref) if complete
                else {"loss": math.inf, "grad": math.inf, "change": math.inf})
    return {"setup_s": setup_s, "window": win,
            "attempted": win["steps"], "failed": 0 if win["finite"]
            else win["steps"],
            "readings": {k: readings[k] for k in ("loss", "grad", "change")},
            "notes": dict({k: readings[k] for k in readings
                           if k not in ("loss", "grad", "change")},
                          setup_phases_s=phases),
            "ok": win["finite"] and complete,
            "e2e": {"train_tokens_per_s": win["tokens"] / win["seconds"]}}
