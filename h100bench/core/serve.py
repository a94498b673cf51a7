"""The serving driver: a closed loop of clients on a started
``InferenceEngine``, through ``submit`` and each request's result.

Set-up starts the engine (the kernels' build or load, its warm-up step),
starts every client and waits until the engine has admitted one request
per slot: the ramp of the clients' first requests, whose budgets spread
their completions.  The window then runs for ``--seconds``; a traced run
profiles ``trace_s`` more of the running loop after it.  Then the clients
stop sending and the requests in flight finish (each waited for up to
``drain_s``).

The rate counts every token that requests emitted inside the window.  A
client sees a request whole: sent at ``s``, answered at ``c`` with ``n``
tokens.  The decode loop advances every live slot one token a step, so
each request's tokens are taken as emitted evenly over ``[s, c]``, and
the window counts ``n`` times the share of ``[s, c]`` that lies inside
it.  Requests that lie wholly inside count whole; the ones cut by the
window's ends count in part.

``correct``: every request that overlaps the window is answered, with
its whole budget (greedy, no end token), with ids in the vocabulary; and
a sample drawn from the seed of the finished requests, the longest among
them, is teacher-forced through the plain reference, whose widest gap
between its best logit and a served token's is held to its limit.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..reference import compare
from . import traffic as gen
from . import weights
from .model import port_config
from .trace import Profiled

#: how long set-up waits for the ramp to fill every slot
RAMP_TIMEOUT_S = 240.0


class ClosedLoop:
    """One thread per client; each sends its next request when its last
    one is answered, until :meth:`close`."""

    def __init__(self, engine, plan: list, temperature: float):
        self.engine = engine
        self.plan = plan
        self.temperature = temperature
        self.lock = threading.Lock()
        self.records: list = []          # (Request, s, c, Completion|None, err)
        self.inflight: dict = {}         # client -> (Request, s)
        self.exhausted: list = []
        self.closed = threading.Event()
        self.threads = [threading.Thread(target=self._client, args=(i,),
                                         daemon=True, name=f"client-{i}")
                        for i in range(len(plan))]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def close(self) -> None:
        self.closed.set()

    def join(self, timeout: float) -> bool:
        end = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(0.0, end - time.perf_counter()))
        return not any(t.is_alive() for t in self.threads)

    def _client(self, ci: int) -> None:
        for req in self.plan[ci]:
            if self.closed.is_set():
                return
            s = time.perf_counter()
            with self.lock:
                self.inflight[ci] = (req, s)
            comp, err = None, None
            try:
                handle = self.engine.submit(req.prompt, req.budget,
                                            temperature=self.temperature)
                comp = handle.result()
            except Exception as e:      # a failed request is counted
                err = repr(e)
            c = time.perf_counter()
            with self.lock:
                self.inflight.pop(ci, None)
                self.records.append((req, s, c, comp, err))
        with self.lock:
            self.exhausted.append(ci)


def _overlap(s: float, c: float, t0: float, t1: float) -> float:
    """The share of ``[s, c]`` inside ``[t0, t1]``."""
    if c <= s:
        return 1.0 if t0 <= s < t1 else 0.0
    return max(0.0, min(c, t1) - max(s, t0)) / (c - s)


def _snapshot():
    from deeplearning4j_tpu_torch.observability import METRICS

    return METRICS.snapshot()


def build_engine(ctx, seed: int):
    import torch

    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.serving import engine as eng

    s = ctx.settings
    cfg = port_config(ctx.model, s, ttr, torch)
    params = weights.make(ctx.model, seed, ctx.device)
    engine = eng.InferenceEngine(ttr.TransformerLM(cfg, device=ctx.device),
                                 params, cfg=eng.ServingConfig(**s["engine"]),
                                 device=ctx.device)
    for hook in ctx.engine_hooks:
        hook(engine)
    if ctx.ranges is not None:
        for attr, op in (("_admit", "admit"), ("_prefill", "prefill"),
                         ("_decode_segment", "decode_segment"),
                         ("_resolve", "resolve")):
            fn = getattr(engine, attr, None)
            if fn is not None:
                setattr(engine, attr, ctx.ranges.wrap(fn, op))
    return engine


def serve_window(ctx, engine, plan, setup_clock=None) -> dict:
    """Set-up's ramp, the window and the drain; returns what the clients
    saw and the window's bounds."""
    tr = ctx.cell.traffic
    slots = ctx.settings["engine"]["slots"]
    loop = ClosedLoop(engine, plan, tr["temperature"])
    loop.start()
    t_ramp = time.perf_counter()
    while engine.stats()["admitted"] < slots:
        if time.perf_counter() - t_ramp > RAMP_TIMEOUT_S:
            loop.close()
            raise RuntimeError(f"the ramp admitted {engine.stats()['admitted']}"
                               f" of {slots} slots in {RAMP_TIMEOUT_S} s")
        time.sleep(0.005)
    setup_s = setup_clock() if setup_clock is not None else None
    t0 = time.perf_counter()
    snap0 = _snapshot()
    ctx.in_window = True
    time.sleep(max(0.0, t0 + ctx.seconds - time.perf_counter()))
    ctx.in_window = False
    t1 = time.perf_counter()
    snap1 = _snapshot()
    with loop.lock:
        early = list(loop.exhausted)
    if ctx.trace:
        # after the window, the loop still running: the profiler slows
        # the host-paced loop, and the window's numbers stay its own
        with Profiled(ctx.ranges) as p:
            time.sleep(tr["trace_s"])
        ctx.traced = p.result
    loop.close()
    drained = loop.join(tr["drain_s"])
    return {"loop": loop, "t0": t0, "t1": t1, "snap0": snap0,
            "snap1": snap1, "drained": drained, "setup_s": setup_s,
            "exhausted_in_window": early}


def account(ctx, w: dict) -> dict:
    """Tokens in the window, what was attempted and what failed."""
    loop, t0, t1 = w["loop"], w["t0"], w["t1"]
    vocab = ctx.model["vocab_size"]
    tokens, attempted, failed, requests = 0.0, 0, 0, []
    for req, s, c, comp, err in loop.records:
        share = _overlap(s, c, t0, t1)
        if share <= 0.0:
            continue
        attempted += 1
        good = (comp is not None and err is None
                and len(comp.tokens) == req.budget
                and comp.finish_reason == "length"
                and all(0 <= t < vocab for t in comp.tokens))
        if not good:
            failed += 1
            continue
        tokens += share * len(comp.tokens)
        requests.append({"prompt": len(req.prompt), "tokens": len(comp.tokens),
                         "share": share})
    with loop.lock:
        unanswered = list(loop.inflight.values())
    for req, s in unanswered:         # in flight past the drain: never came
        if s < t1:
            attempted += 1
            failed += 1
    return {"seconds": t1 - t0, "tokens": tokens, "attempted": attempted,
            "failed": failed, "requests": requests}


def sample(ctx, loop, seed: int) -> list:
    """The finished requests to check: the longest, and the rest drawn
    from the seed."""
    done = [(req, comp) for req, s, c, comp, err in loop.records
            if comp is not None and err is None]
    if not done:
        return []
    k = min(ctx.cell.traffic["check_requests"], len(done))
    longest = max(range(len(done)), key=lambda i: len(done[i][1].tokens))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng(seed)
    pick = [longest] + [rest[i] for i in
                        rng.choice(len(rest), k - 1, replace=False)]
    return [done[i] for i in pick]


def check(ctx, seed: int, picked: list, quant=None) -> float:
    """The widest gap over the picked requests."""
    params = weights.make(ctx.model, seed, ctx.device)
    gaps = []
    for req, comp in picked:
        gaps += compare.served_gaps(params, ctx.model, req.prompt,
                                    list(comp.tokens), ctx.device, quant)
    return max(gaps) if gaps else float("inf")


def run(ctx, setup_clock) -> dict:
    import torch

    engine = build_engine(ctx, ctx.seed)
    engine.start()
    plan = gen.serve_plan(ctx.cell.traffic, ctx.seed)
    try:
        w = serve_window(ctx, engine, plan, setup_clock)
    finally:
        if ctx.on_card:
            ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
        engine.stop()
    w["loop"].join(30.0)
    acc = account(ctx, w)
    ctx.window = acc
    ctx.program = {"t0": w["snap0"], "t1": w["snap1"]}
    del engine
    if ctx.on_card:
        torch.cuda.empty_cache()
    picked = sample(ctx, w["loop"], ctx.seed)
    gap = check(ctx, ctx.seed, picked)
    ok = w["drained"] and not w["exhausted_in_window"] and picked != []
    return {"setup_s": w["setup_s"], "window": acc,
            "attempted": acc["attempted"], "failed": acc["failed"],
            "readings": {"token_gap": gap},
            "notes": {"checked_requests": len(picked),
                      "checked_tokens": sum(len(c.tokens) for _, c in picked),
                      "drained": w["drained"],
                      "clients_out_of_requests": w["exhausted_in_window"]},
            "ok": ok and acc["failed"] == 0,
            "e2e": {"serve_tokens_per_s": acc["tokens"] / acc["seconds"]},
            "loop": w["loop"]}
