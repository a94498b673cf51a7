"""Serving load generator: drive the full HTTP stack, report latency + fill.

Port of ``tools/serving_smoke.py``.  Spins up a random transformer (the
reference's tiny config unless ``cfg`` names another, e.g. the flagship's
full width), an :class:`InferenceEngine`, a :class:`BatchScorer` and a
:class:`ModelServer` on a free port, then fires ``--requests`` generations
from ``--threads`` concurrent clients (random prompt lengths/temperatures/
budgets from ``--seed``, drawn from ``random.Random(seed)`` exactly as the
reference draws them).  Everything observable flows through the metrics
registry — the JSON result line reports p50/p99 request latency and queue
wait, time-to-first-token, batch fill ratio and tokens/sec exactly as a
Prometheus scrape of ``/metrics.prom`` would see them, in the reference's
keys (``tools/perf_gate.py --record`` reads them).

    python -m deeplearning4j_tpu_torch.tools.serving_smoke [--platform cpu]
        [--requests 32] [--threads 4] [--seed 0] [--lockguard]
        [--prefix-workload [--kv-quant int8]] [--trace-out trace.json]
        [--slo] [--online] [--autoscale] [--disagg] [--fleet]
        [--replicas N [--strict-scaling]]

The legs run on the card unless ``--platform cpu`` is passed (or a leg
is called with ``device="cpu"``); without a card they raise, never
dropping to the CPU.  Every leg takes ``cfg`` (``None``: the reference's
tiny config) and ``device``; ``run``, ``run_prefix``, ``run_slo`` and
``run_disagg`` also take ``serving`` (a dict of :class:`ServingConfig`
fields laid over the leg's own, ``page_size`` excepted; with a quantized
KV leg a ``"pallas"`` /``"cuda"`` ``paged_attention_impl`` reads the
quantized kind):
``chip_smoke.py`` drives ``run``, ``run_prefix``, ``run_slo`` and
``run_disagg`` at the flagship's width through the paged-attention and
int8 kernels that way.  Wherever a leg holds served tokens to offline
``TransformerLM.sample``, the offline reference reads the tree the engine
decodes with (the int8 serving tree under ``int8_decode``).

``--disagg``: a bimodal workload through the prefill tier + KV-page
migration while prefill-heavy background load runs at 1x and then 2x;
FAILS unless every migrated decode matches the offline reference
token-for-token and the decode stream's p99 inter-token latency at 2x
stays within 1.15x of 1x.

``--autoscale``: an ``Autoscaler`` scales a live router pool 1 -> 2 -> 1
through the real warm-before-admission / drain-before-remove seams with a
greedy probe held token-identical, then a deterministic diurnal-plus-spike
day must hold the TTFT objective (>= 95% of simulated time) with fewer
replica-hours than a static peak fleet (``{"autoscale": {"saved_frac"}}``).

``--online``: waves of greedy traffic through a ``ModelServer`` whose
capture hook feeds a ``CaptureStore``; between waves an ``OnlineLoop``
round fine-tunes, publishes and hot-reloads.  FAILS unless every
response matches offline sampling under its own ``loaded_step`` stamp
and a reload applied.

``--slo``: the Zipf workload under a ``TimeSeriesStore`` and an
``SLOEvaluator`` over smoke-sized windows (``--window``, default 2 s);
FAILS unless an objective reaches a full window with a burn rate.  With
``DL4J_TPU_TS_DIR`` set the samples land as JSONL for
``tools/metrics_dump.py --timeline``.

``--lockguard`` runs the smoke under the port's instrumented locks
(``analysis.lockguard``); violations fail the run.

``--trace-out PATH`` saves a merged Chrome trace (each client call opens
a ``client.generate`` span whose trace id rides ``traceparent``) and
FAILS unless every completed request carries the full queue_wait ->
prefill -> decode -> emit chain under one trace id; ``tools/
trace_report.py PATH`` reads it.

``--fleet``: a Zipf multi-tenant workload over ``--replicas N`` (default
3) process replicas (``serving.router.procserver:tiny_lm_factory``),
federated through a ``FleetScraper``: federated token counters equal the
replicas' own and the client's, exactly (overall and per tenant); a
SIGKILL of one replica marks only it stale; a synthetic ramp's
``forecast_breach`` lands before the breach.

``--replicas N``: the Zipf workload through a ``RouterServer`` over one
replica, then over N: aggregate hit rate >= one replica's, affinity,
throughput, and greedy parity including spills (``--strict-scaling``
asks >= 0.6*N throughput).

``--prefix-workload``: Zipf-shared system prompts against a paged +
prefix-cache engine under a ``/metrics.prom`` poller: hit rate > 0 and
paged bytes/slot under the dense baseline; ``--kv-quant int8`` runs a
float leg then a quantized one and FAILS unless bytes/slot drops >= 1.9x,
the hit rate holds, and greedy tokens agree top-1 >= 0.999 (on weights
``_sharpen`` trained to decisive margins, on a stream that differs from
the reference's: see there).

Exits nonzero if any request fails, the registry is missing a serving
histogram, or lockguard saw a violation.
"""

from __future__ import annotations

import dataclasses
import json
import random
import sys
import threading
from pathlib import Path

#: the reference tools' tiny transformer (``tools/serving_smoke.py:138``)
TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=64, remat=False, xent_chunk=0)


def _init_params(model, seed: int):
    """The leg's random weights, drawn from ``seed`` on a CPU generator
    (the same weights on the CPU and on the card)."""
    import torch

    return model.init(torch.Generator().manual_seed(seed))


def _tiny_lm(cfg, device, seed: int, **over):
    """``(cfg, model, params)``: ``cfg``, or the reference's tiny f32
    config with ``over``'s fields, on ``device``."""
    import torch

    from ..models.transformer import TransformerConfig, TransformerLM

    if cfg is None:
        cfg = TransformerConfig(**{**TINY, "dtype": torch.float32, **over})
    model = TransformerLM(cfg, device=device)
    return cfg, model, _init_params(model, seed)


def _serving_cfg(base, serving: dict | None):
    """``base`` with ``serving``'s fields laid over it; on quantized pages
    a kernel ``paged_attention_impl`` names the quantized kind.  A leg
    sizes its prompts in its own pages, so ``serving`` may not set
    ``page_size`` (a leg that takes one has a ``page_size`` keyword)."""
    if not serving:
        return base
    if "page_size" in serving:
        raise ValueError("serving may not set page_size: the leg sizes its "
                         "workload in its own pages")
    over = dict(serving)
    impl = over.get("paged_attention_impl")
    if base.kv_quant is not None and impl in ("pallas", "cuda"):
        over["paged_attention_impl"] = impl + "_int8"
    return dataclasses.replace(base, **over)


def _offline_params(model, params, scfg):
    """The tree an engine of ``scfg`` decodes with, for offline
    ``sample``: the int8 serving tree under ``int8_decode``."""
    if not scfg.int8_decode:
        return params
    import torch

    from ..ops.cuda.matmul_int8 import quantize_params_for_decode

    with torch.no_grad():
        return quantize_params_for_decode(params, model.cfg)


def _greedy(model, params, prompt, n: int, seed: int = 0) -> list[int]:
    """Offline greedy continuation of ``prompt`` (``n`` tokens)."""
    return model.sample(params, prompt, n, temperature=0.0, seed=seed,
                        kv_cache=True)[len(prompt):]


def _fan_out(fn, items: list, threads: int) -> None:
    """``fn(items[i::threads])`` on ``threads`` threads, joined."""
    ts = [threading.Thread(target=fn, args=(items[i::threads],))
          for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def _pct(timers: dict, name: str):
    t = timers.get(name)
    return {"p50": t["p50_s"], "p99": t["p99_s"], "count": t["count"],
            "mean": t["mean_s"]} if t else None


def _zipf_plans(rng: random.Random, vocab: int, requests: int,
                sys_len: int, n_tenants: int = 6) -> list[dict]:
    """The reference's Zipf-skewed tenant workload: ``n_tenants`` shared
    system prompts of ``sys_len`` tokens, rank-1 dominating, each request
    one of them plus 1-5 user tokens."""
    sys_prompts = [[rng.randrange(vocab) for _ in range(sys_len)]
                   for _ in range(n_tenants)]
    zipf_w = [1.0 / (r + 1) ** 1.5 for r in range(n_tenants)]
    plans = []
    for _ in range(requests):
        tenant = rng.choices(range(n_tenants), weights=zipf_w)[0]
        user = [rng.randrange(vocab) for _ in range(rng.randint(1, 5))]
        plans.append(dict(prompt=sys_prompts[tenant] + user,
                          max_new_tokens=rng.randint(1, 8),
                          temperature=rng.choice([0.0, 0.7]),
                          seed=rng.randrange(1 << 20)))
    return plans


def _install_guard(lockguard: bool):
    if not lockguard:
        return None
    from ..analysis.lockguard import LockGuard

    return LockGuard().install()


def _guard_failures(guard, failures: list) -> None:
    if guard is not None:
        guard.uninstall()
        guard.emit_metrics()
        failures.extend(str(v) for v in guard.violations())


def _merge_trace(path: str) -> dict:
    """Rewrite the Chrome trace at ``path`` as ``tools/trace_report.py``'s
    ``merge`` of that one file would (events by time, ``dropped`` and
    ``sources`` in the metadata) and return it."""
    obj = json.loads(Path(path).read_text())
    merged = {"traceEvents": sorted(obj["traceEvents"],
                                    key=lambda e: e.get("ts", 0.0)),
              "displayTimeUnit": "ms",
              "metadata": {"dropped": int((obj.get("metadata") or {})
                                          .get("dropped", 0)),
                           "sources": [str(path)]}}
    Path(path).write_text(json.dumps(merged))
    return merged


def _routed_requests(events: list[dict]) -> int:
    """Requests (trace ids with a ``serving.request`` root) that crossed a
    router hop: ``trace_report.py``'s rows with ``route_hops > 0``."""
    names: dict[str, set] = {}
    for ev in events:
        name = str(ev.get("name", ""))
        tid = (ev.get("args") or {}).get("trace_id")
        if ev.get("ph") == "X" and tid and name.startswith(("serving.",
                                                             "router.")):
            names.setdefault(tid, set()).add(name)
    return sum(1 for s in names.values()
               if "serving.request" in s and "router.route" in s)


def run(requests: int = 32, threads: int = 4, seed: int = 0,
        lockguard: bool = False, trace_out: str | None = None, *,
        cfg=None, serving: dict | None = None, device=None) -> dict:
    import numpy as np
    import torch

    from .. import observability
    from ..device import resolve_device
    from ..observability import METRICS, TRACER, trace
    from ..serving import (BatchScorer, InferenceEngine, ModelServer,
                           ServingClient, ServingConfig, ServingError)

    dev = resolve_device(device)
    observability.enable()
    METRICS.reset()
    if trace_out is not None:
        TRACER.clear()
    guard = _install_guard(lockguard)

    cfg, model, params = _tiny_lm(cfg, dev, 7)

    def score_fn(x):
        # any row-wise fn serves; use the LM's own forward as the scorer
        return model.forward(params, torch.as_tensor(
            np.asarray(x), dtype=torch.long, device=dev))[:, -1, :]

    rng = random.Random(seed)
    failures: list[str] = []
    statuses: list[int] = []
    lock = threading.Lock()

    engine = InferenceEngine(model, params=params, cfg=_serving_cfg(
        ServingConfig(slots=4, resolve_every=4), serving), device=dev)
    scorer = BatchScorer(score_fn, max_batch=16)
    with engine, scorer, ModelServer(engine=engine, scorer=scorer) as server:
        client = ServingClient(port=server.port)
        plans = [dict(prompt=[rng.randrange(cfg.vocab_size)
                              for _ in range(rng.randint(1, 12))],
                      max_new_tokens=rng.randint(1, 10),
                      temperature=rng.choice([0.0, 0.7, 1.0]),
                      seed=rng.randrange(1 << 20))
                 for _ in range(requests)]

        completed_traces: list[str] = []

        def worker(mine):
            for plan in mine:
                try:
                    # a client-side span per call: its trace id rides the
                    # traceparent header, so the server JOINS this trace
                    with trace.span("client.generate") as sp:
                        out = client.generate(**plan)
                    with lock:
                        statuses.append(200)
                        if getattr(sp, "trace_id", ""):
                            completed_traces.append(sp.trace_id)
                    if len(out["tokens"]) > plan["max_new_tokens"]:
                        with lock:
                            failures.append(f"overlong answer for {plan}")
                except ServingError as e:
                    with lock:
                        statuses.append(e.status)
                        failures.append(str(e))

        _fan_out(worker, plans, threads)
        # one scorer round-trip through HTTP as well
        rows = [[rng.randrange(cfg.vocab_size) for _ in range(4)]
                for _ in range(6)]
        outputs = client.score(rows)
        if len(outputs) != len(rows):
            failures.append("score row count mismatch")
        health = client.healthz()
        prom = client.metrics_prom()

    _guard_failures(guard, failures)

    trace_summary = None
    if trace_out is not None:
        # engine + server + client all live in this process, so the
        # tracer already holds every side's spans; write, then round-trip
        # through the merge so the output has a multi-process merge's shape
        TRACER.save_chrome_trace(trace_out)
        merged = _merge_trace(trace_out)
        events = merged["traceEvents"]
        by_trace: dict[str, set] = {}
        tokens_by_trace: dict[str, int] = {}
        for ev in events:
            tid = (ev.get("args") or {}).get("trace_id")
            if not tid:
                continue
            by_trace.setdefault(tid, set()).add(ev["name"])
            if ev["name"] == "serving.request":
                tokens_by_trace[tid] = int((ev.get("args") or {}).get(
                    "tokens") or 0)
        need = {"serving.request", "serving.queue_wait",
                "serving.prefill", "serving.emit"}
        for tid in completed_traces:
            names = by_trace.get(tid, set())
            missing_spans = need - names
            # a 1-token answer legitimately finishes inside prefill —
            # decode segments are only required when decode actually ran
            if tokens_by_trace.get(tid, 0) > 1 and \
                    "serving.decode.segment" not in names:
                missing_spans.add("serving.decode.segment")
            if missing_spans:
                failures.append(
                    f"trace {tid[:12]} missing spans {sorted(missing_spans)}")
        trace_summary = {"path": trace_out, "events": len(events),
                         "requests_traced": len(completed_traces),
                         "dropped": merged["metadata"]["dropped"]}

    snap = METRICS.snapshot()
    timers, gauges = snap["timers"], snap["gauges"]
    required = ["serving.request_latency", "serving.queue_wait",
                "serving.ttft", "serving.batch_fill_ratio",
                "serving.decode_step"]
    missing = [n for n in required
               if n not in timers
               or n.replace(".", "_") + "_seconds" not in prom]
    result = {
        "requests": requests,
        "threads": threads,
        "seed": seed,
        "completed": statuses.count(200),
        "rejected": len(statuses) - statuses.count(200),
        "request_latency_s": _pct(timers, "serving.request_latency"),
        "queue_wait_s": _pct(timers, "serving.queue_wait"),
        "ttft_s": _pct(timers, "serving.ttft"),
        "batch_fill_ratio": _pct(timers, "serving.batch_fill_ratio"),
        "tokens_per_sec": gauges.get("serving.tokens_per_sec"),
        "tokens_total": snap["counters"].get("serving.tokens"),
        "prefill_buckets": health["engine"]["prefill_buckets"],
        "missing_histograms": missing,
        "failures": failures[:5],
    }
    if trace_summary is not None:
        result["trace"] = trace_summary
    if guard is not None:
        result["lockguard_violations"] = len(guard.violations())
    assert not failures, failures[:5]
    assert not missing, f"registry missing serving histograms: {missing}"
    assert result["completed"] == requests
    return result


#: the sharpening stream's row length (rows of max_len at the tiny configs)
SHARPEN_ROW = 128


def _sharpen(model, params, cfg, steps: int = 80):
    """A few SGD steps (lr 0.5) so greedy decoding has decisive top-2
    logit margins.  A randomly-initialized model's logits are near-flat —
    its argmax is a coin toss that ANY perturbation (including int8 KV
    quantization, ~0.2% of activation absmax) can flip, which would make
    token-agreement floors measure init noise instead of the quantizer.
    Trained margins make the >= 0.999 agreement assertion test the
    quantizer.

    The stream differs from the reference's, which trains four rows of
    ``0, 1, ..., vocab-1, 0, ...`` cut at ``max_len``, each token's target
    the next.  There token and position agree, so after a prompt of
    random tokens they point at different answers: this package's seed-7
    draw kept a smallest top-2 margin of 0.004 at the tiny config's 62
    greedy tokens of the prefix workload, where int8 pages flipped 5 (and
    so does the reference's engine on those weights, token for token: the
    flips are the draw's).  At the flagship's width (vocab 32768) a
    successor target is not learnt in 80 steps at all (an H100: the loss
    went 10.55 -> 10.43, uniform being 10.40; median margin 0.05, and
    int8 pages agreed on 0.984 of the tokens).  So each step here draws
    ``4 * max_len`` uniformly random tokens (a CPU generator seeded 0:
    the same on any device) in rows of ``min(max_len, SHARPEN_ROW)``, and
    each token's target is the token itself, which a tied-embedding model
    learns for every token at once: at the flagship's width the loss went
    10.46 -> 8.26 in the 80 steps (median margin 0.58, agreement 1.0 on an
    H100); at the tiny configs the smallest margin at the greedy tokens
    is 1.4-3.0."""
    import torch

    from ..models.transformer import lm_loss_local
    from ..utils.tree_math import tree_leaves, tree_map

    dev = params["tok_embed"].device
    gen = torch.Generator().manual_seed(0)
    row = min(cfg.max_len, SHARPEN_ROW)
    rows = 4 * cfg.max_len // row
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      params)
    leaves = tree_leaves(params)
    for _ in range(steps):
        toks = torch.randint(cfg.vocab_size, (rows, row),
                             generator=gen).to(dev)
        grads = torch.autograd.grad(lm_loss_local(params, toks, toks, cfg),
                                    leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(0.5 * g)
    return tree_map(lambda p: p.detach(), params)


def _top2_margins(model, params, served: list) -> dict | None:
    """Top-1 minus top-2 logit at every generated position of the
    ``(prompt, tokens)`` pairs in ``served``, teacher-forced through the
    full forward: how decisive the greedy picks the agreement floor
    compares were (min and median)."""
    import torch

    margins = []
    with torch.no_grad():
        for prompt, toks in served:
            if not toks:
                continue
            seq = list(prompt) + list(toks[:-1])
            logits = model.forward(params, [seq])[0, len(prompt) - 1:]
            top = torch.topk(logits.float(), 2, dim=-1).values
            margins += (top[:, 0] - top[:, 1]).tolist()
    if not margins:
        return None
    margins.sort()
    return {"min": margins[0], "p50": margins[len(margins) // 2],
            "positions": len(margins)}


def _scrape_gauges(prom_text: str, names: tuple[str, ...]) -> dict:
    """Parse plain ``name value`` gauge samples out of a Prometheus
    exposition page (comments and histogram series skipped)."""
    out: dict[str, float] = {}
    for line in prom_text.splitlines():
        if line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) == 2 and parts[0] in names:
            try:
                out[parts[0]] = float(parts[1])
            except ValueError:
                pass
    return out


def _scrape_counters(prom_text: str, names: tuple[str, ...]) -> dict:
    """Counter samples (``name_total value``) from a Prometheus page."""
    return _scrape_gauges(prom_text, names)


def run_prefix(requests: int = 32, threads: int = 4, seed: int = 0,
               page_size: int = 6, lockguard: bool = False,
               kv_quant: str | None = None, *, cfg=None,
               serving: dict | None = None, device=None) -> dict:
    """The ``--prefix-workload`` leg: Zipf-shared system prompts against
    a paged + prefix-cache engine, observed through real scrapes.

    With ``kv_quant`` set (``--kv-quant int8``) the SAME workload runs
    twice — float leg then quantized leg — and the run FAILS unless the
    scraped peak ``serving.kv_bytes_per_slot`` drops >= 1.9x, the prefix
    hit rate does not regress, and temperature-0 served tokens agree
    top-1 >= 0.999 between the legs (the result also carries the
    sharpened weights' top-2 margins at the float leg's greedy tokens)."""
    import time as _time

    import torch

    from .. import observability
    from ..device import resolve_device
    from ..observability import METRICS
    from ..serving import (InferenceEngine, ModelServer, ServingClient,
                           ServingConfig, ServingError)

    dev = resolve_device(device)
    observability.enable()
    guard = _install_guard(lockguard)

    cfg, model, params = _tiny_lm(cfg, dev, 7)
    if kv_quant is not None:
        params = _sharpen(model, params, cfg)
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    dense_bytes_per_slot = (cfg.max_len * cfg.n_heads * cfg.head_dim * 2
                            * cfg.n_layers * itemsize)

    rng = random.Random(seed)
    # Zipf-skewed tenant population: a handful of shared system prompts
    # (4 full pages each), rank-1 dominating — the shape prefix sharing
    # exists for
    plans = _zipf_plans(rng, cfg.vocab_size, requests, 4 * page_size)

    scrape_names = ("serving_prefix_hit_rate", "serving_kv_pages_in_use",
                    "serving_kv_bytes_per_slot", "serving_kv_bytes")

    def leg(kvq: str | None) -> dict:
        """One full pass of the workload against a fresh engine; scraped
        peaks + per-plan completions for cross-leg agreement."""
        METRICS.reset()
        failures: list[str] = []
        statuses: list[int] = []
        tokens_by_plan: dict[int, list[int]] = {}
        lock = threading.Lock()
        scraped: dict[str, float] = {}   # name -> peak value seen
        done = threading.Event()

        engine = InferenceEngine(
            model, params=params,
            cfg=_serving_cfg(ServingConfig(
                slots=4, resolve_every=4, paged=True, page_size=page_size,
                prefix_cache=True, kv_quant=kvq), serving), device=dev)
        with engine, ModelServer(engine=engine) as server:
            client = ServingClient(port=server.port)

            def scraper():
                # a real Prometheus poller: GET /metrics.prom on an
                # interval, keep the peaks (footprint claims come from
                # scrapes, not from reaching into the engine)
                while not done.is_set():
                    try:
                        vals = _scrape_gauges(client.metrics_prom(),
                                              scrape_names)
                        with lock:
                            for k, v in vals.items():
                                scraped[k] = max(scraped.get(k, 0.0), v)
                    except ServingError:
                        pass
                    done.wait(0.05)

            def worker(mine):
                for idx, plan in mine:
                    try:
                        out = client.generate(**plan)
                        with lock:
                            statuses.append(200)
                            tokens_by_plan[idx] = out["tokens"]
                        if len(out["tokens"]) > plan["max_new_tokens"]:
                            with lock:
                                failures.append(
                                    f"overlong answer for {plan}")
                    except ServingError as e:
                        with lock:
                            statuses.append(e.status)
                            failures.append(str(e))

            scrape_t = threading.Thread(target=scraper, daemon=True)
            scrape_t.start()
            _fan_out(worker, list(enumerate(plans)), threads)
            _time.sleep(0.1)             # let eviction-fence gauges land
            final = _scrape_gauges(client.metrics_prom(), scrape_names)
            done.set()
            scrape_t.join()
            with lock:
                for k, v in final.items():
                    scraped[k] = max(scraped.get(k, 0.0), v)
        return {"failures": failures, "completed": statuses.count(200),
                "rejected": len(statuses) - statuses.count(200),
                "scraped": scraped, "tokens": tokens_by_plan}

    float_leg = leg(None)
    quant_leg = leg(kv_quant) if kv_quant is not None else None
    primary = quant_leg if quant_leg is not None else float_leg
    failures = list(float_leg["failures"])
    if quant_leg is not None:
        failures += quant_leg["failures"]
    _guard_failures(guard, failures)

    timers = METRICS.snapshot()["timers"]
    hit_rate = primary["scraped"].get("serving_prefix_hit_rate", 0.0)
    peak_bytes_per_slot = primary["scraped"].get(
        "serving_kv_bytes_per_slot", 0.0)
    float_bytes_per_slot = float_leg["scraped"].get(
        "serving_kv_bytes_per_slot", 0.0)
    result = {
        "workload": "prefix",
        "requests": requests,
        "threads": threads,
        "seed": seed,
        "page_size": page_size,
        "kv_quant": kv_quant,
        "completed": primary["completed"],
        "rejected": primary["rejected"],
        "request_latency_s": _pct(timers, "serving.request_latency"),
        "ttft_s": _pct(timers, "serving.ttft"),
        "prefix_hit_rate": hit_rate,
        "kv_pages_in_use_peak": primary["scraped"].get(
            "serving_kv_pages_in_use"),
        "kv_bytes_per_slot_peak": peak_bytes_per_slot,
        "dense_kv_bytes_per_slot": dense_bytes_per_slot,
        "failures": failures[:5],
    }
    if guard is not None:
        result["lockguard_violations"] = len(guard.violations())
    assert not failures, failures[:5]
    assert float_leg["completed"] == requests
    assert primary["completed"] == requests
    assert hit_rate > 0.0, "prefix cache never hit under a Zipf workload"
    assert 0.0 < peak_bytes_per_slot < dense_bytes_per_slot, (
        f"paged KV bytes/slot {peak_bytes_per_slot} not below dense "
        f"baseline {dense_bytes_per_slot}")

    if quant_leg is not None:
        # the capacity claim, observed through real scrapes: quantized
        # bytes/slot must drop >= 1.9x, locality must hold, and greedy
        # served tokens must agree top-1 across the legs
        shrink = (float_bytes_per_slot / peak_bytes_per_slot
                  if peak_bytes_per_slot else 0.0)
        float_hit = float_leg["scraped"].get("serving_prefix_hit_rate", 0.0)
        agree, compared, greedy = 0, 0, []
        for idx, plan in enumerate(plans):
            if plan["temperature"] != 0.0:
                continue
            a = float_leg["tokens"].get(idx)
            b = quant_leg["tokens"].get(idx)
            if a is None or b is None:
                continue
            compared += len(a)
            agree += sum(1 for x, y in zip(a, b) if x == y)
            greedy.append((plan["prompt"], a))
        agreement = agree / compared if compared else 0.0
        result["kv_bytes_per_slot_float"] = float_bytes_per_slot
        result["kv_bytes_per_slot_shrink"] = shrink
        result["prefix_hit_rate_float"] = float_hit
        result["greedy_token_agreement"] = agreement
        result["greedy_tokens_compared"] = compared
        result["greedy_top2_margin"] = margins = _top2_margins(
            model, params, greedy)
        assert shrink >= 1.9, (
            f"kv_quant={kv_quant} bytes/slot shrink {shrink:.2f}x under "
            "the 1.9x floor")
        assert hit_rate >= float_hit - 0.05, (
            f"prefix hit rate regressed under kv_quant: {hit_rate:.3f} vs "
            f"float {float_hit:.3f}")
        assert compared > 0, "no greedy completions to compare across legs"
        assert agreement >= 0.999, (
            f"served-token top-1 agreement {agreement:.4f} under the "
            f"0.999 floor (top-2 margins {margins})")
    return result


def run_disagg(requests: int = 24, threads: int = 3, seed: int = 0,
               lockguard: bool = False, *, page_size: int = 8, cfg=None,
               serving: dict | None = None, device=None) -> dict:
    """The ``--disagg`` leg: a bimodal workload against the disaggregated
    prefill/decode tier.

    Decode-heavy requests (short prompts, 16-token budgets) stream
    while prefill-heavy background traffic (page-spanning prompts,
    1-token budgets) runs at 1x and then at DOUBLE the load.  The run
    FAILS unless (a) every decode answer matches ``TransformerLM.sample``
    token-for-token — migration parity under load — and (b) the decode
    stream's p99 inter-token latency at 2x prefill load stays within
    1.15x of its 1x baseline.  The shared background prompts also
    exercise the content-addressed dedup path (``{"disagg":
    {"dedup_frac": ...}}``).  The background prompts span 5 pages of
    ``page_size`` tokens (the reference's 8; a keyword of the port's)."""
    result, ratio = _disagg(requests, threads, seed, lockguard, cfg,
                            serving, device, page_size)
    assert ratio is not None and ratio <= 1.15, (
        f"decode p99 inter-token degraded {ratio:.2f}x when prefill load "
        f"doubled — the tiers are not isolated ({result})")
    return result


def _disagg(requests, threads, seed, lockguard, cfg, serving, device,
            page_size: int = 8):
    """:func:`run_disagg` but for its one wall-clock assertion (the p99
    inter-token isolation): its result and the unrounded ratio."""
    from .. import observability
    from ..device import resolve_device
    from ..observability import METRICS
    from ..serving import DisaggScheduler, InferenceEngine, ServingConfig

    dev = resolve_device(device)
    observability.enable()
    METRICS.reset()
    guard = _install_guard(lockguard)

    cfg, model, params = _tiny_lm(cfg, dev, 7)

    def scfg(role):
        return _serving_cfg(ServingConfig(
            slots=4, resolve_every=4, max_queue=64, paged=True,
            page_size=page_size, prefix_cache=True, role=role), serving)

    def mk(role):
        return InferenceEngine(model, params=params, cfg=scfg(role),
                               device=dev)

    rng = random.Random(seed)
    # decode-heavy stream: short prompts, long budgets, greedy so every
    # answer is checkable against the offline reference
    dplans = [dict(prompt=[rng.randrange(cfg.vocab_size)
                           for _ in range(rng.randint(4, 9))],
                   max_new_tokens=16, temperature=0.0, seed=0)
              for _ in range(requests)]
    offline = _offline_params(model, params, scfg("decode"))
    expected = [_greedy(model, offline, p["prompt"], 16) for p in dplans]
    del offline
    # prefill-heavy background: a few shared page-spanning prompts
    # (5 full pages), 1-token budgets — nearly all their cost is prefill
    bg_prompts = [[rng.randrange(cfg.vocab_size)
                   for _ in range(5 * page_size)] for _ in range(3)]

    failures: list[str] = []
    lock = threading.Lock()

    pf = mk("prefill")
    dec = mk("decode")
    sched = DisaggScheduler([pf], dec).start()
    try:
        def phase(bg_threads: int, measure: bool) -> dict:
            """Drive the decode stream while ``bg_threads`` background
            loops hammer the prefill tier; per-request mean inter-token
            seconds for the decode stream come back for the p99."""
            stop = threading.Event()
            itls: list[float] = []
            bg_done = [0]

            def bg_loop(k):
                i = k
                while not stop.is_set():
                    try:
                        sched.generate(bg_prompts[i % len(bg_prompts)], 1,
                                       temperature=0.0, seed=0, timeout=120)
                        with lock:
                            bg_done[0] += 1
                    except Exception as e:  # noqa: BLE001 - tallied
                        with lock:
                            failures.append(f"bg: {e}")
                        return
                    i += 1

            def worker(mine):
                for idx, plan in mine:
                    try:
                        c = sched.generate(**plan, timeout=120)
                    except Exception as e:  # noqa: BLE001 - tallied
                        with lock:
                            failures.append(f"decode: {e}")
                        continue
                    if c.tokens != expected[idx]:
                        with lock:
                            failures.append(
                                f"parity: plan {idx} {c.tokens} != "
                                f"{expected[idx]}")
                    if measure and len(c.tokens) > 1:
                        with lock:
                            itls.append((c.latency_s - c.ttft_s)
                                        / (len(c.tokens) - 1))

            bgs = [threading.Thread(target=bg_loop, args=(k,))
                   for k in range(bg_threads)]
            for t in bgs:
                t.start()
            _fan_out(worker, list(enumerate(dplans)), threads)
            stop.set()
            for t in bgs:
                t.join()
            itls.sort()
            p99 = (itls[min(len(itls) - 1, int(0.99 * len(itls)))]
                   if itls else None)
            return {"itl_p99_s": p99, "bg_completed": bg_done[0]}

        # warmup: touch every prompt bucket once so neither measured
        # phase pays first-call costs inside its latency samples
        phase(1, measure=False)
        base = phase(1, measure=True)
        doubled = phase(2, measure=True)
    finally:
        sched.stop()
    _guard_failures(guard, failures)

    snap = METRICS.snapshot()["counters"]
    moved = snap.get("disagg.pages_moved", 0.0)
    deduped = snap.get("disagg.pages_deduped", 0.0)
    dedup_frac = deduped / max(1.0, moved + deduped)
    ratio = (doubled["itl_p99_s"] / base["itl_p99_s"]
             if base["itl_p99_s"] else None)
    result = {
        "workload": "disagg",
        "requests": requests,
        "threads": threads,
        "seed": seed,
        "page_size": page_size,
        "itl_p99_base_s": base["itl_p99_s"],
        "itl_p99_doubled_s": doubled["itl_p99_s"],
        "itl_p99_ratio": round(ratio, 4) if ratio is not None else None,
        "bg_completed": (base["bg_completed"], doubled["bg_completed"]),
        "migrations": snap.get("disagg.migrations", 0.0),
        "requeues": snap.get("disagg.requeues", 0.0),
        "disagg": {"dedup_frac": round(dedup_frac, 4),
                   "pages_moved": moved, "pages_deduped": deduped},
        "failures": failures[:5],
    }
    if guard is not None:
        result["lockguard_violations"] = len(guard.violations())
    assert not failures, failures[:5]
    assert doubled["bg_completed"] >= 2 * base["bg_completed"] * 0.5, (
        "doubled phase did not actually raise prefill load", result)
    assert deduped > 0, "shared background prompts never deduped a page"
    return result, ratio


def run_replicas(requests: int = 48, threads: int = 8, seed: int = 0,
                 replicas: int = 4, page_size: int = 6,
                 lockguard: bool = False, trace_out: str | None = None,
                 strict_scaling: bool = False, *, cfg=None,
                 device=None) -> dict:
    """The ``--replicas N`` leg: one Zipf multi-tenant workload, run
    against a single-replica router and then an N-replica router, with
    affinity / aggregate-hit-rate / throughput / parity assertions."""
    result = _replicas(requests, threads, seed, replicas, page_size,
                       lockguard, trace_out, cfg, device)
    scaling = result["throughput_scaling"]
    floor = 0.6 * replicas if strict_scaling else 0.8
    assert scaling >= floor, (
        f"throughput scaling {scaling:.2f}x under the {floor:.2f}x floor "
        f"({replicas} replicas)")
    return result


def _replicas(requests, threads, seed, replicas, page_size, lockguard,
              trace_out, cfg, device) -> dict:
    """:func:`run_replicas` but for its one wall-clock assertion (the
    throughput floor)."""
    import time as _time

    from .. import observability
    from ..device import resolve_device
    from ..observability import METRICS, TRACER, trace
    from ..serving import (EngineReplica, InferenceEngine, PrefixRouter,
                           RouterConfig, RouterServer, ServingClient,
                           ServingConfig, ServingError)

    dev = resolve_device(device)
    observability.enable()
    METRICS.reset()
    if trace_out is not None:
        TRACER.clear()
    guard = _install_guard(lockguard)

    cfg, model, params = _tiny_lm(cfg, dev, 7)
    rng = random.Random(seed)
    plans = _zipf_plans(rng, cfg.vocab_size, requests, 4 * page_size)
    scfg = ServingConfig(slots=2, resolve_every=4, paged=True,
                         page_size=page_size, prefix_cache=True)
    rcfg = RouterConfig(page_size=page_size, affinity_pages=4,
                        probe_interval_s=0.1, fail_threshold=2,
                        recover_threshold=2)

    def one_leg(n: int, want_traces: bool) -> dict:
        """Drive the full workload through a RouterServer over n fresh
        in-process replicas; returns scraped + client-side measurements."""
        METRICS.reset()
        failures: list[str] = []
        results: list[tuple[dict, dict]] = []     # (plan, completion)
        traces: list[str] = []
        lock = threading.Lock()
        engines = [InferenceEngine(model, params=params, cfg=scfg,
                                   device=dev) for _ in range(n)]
        reps = [EngineReplica(f"r{i}", e, own_engine=True)
                for i, e in enumerate(engines)]
        for e in engines:
            e.start()
        router = PrefixRouter(reps, rcfg)
        with RouterServer(router) as server:
            client = ServingClient(port=server.port)

            def worker(mine):
                for plan in mine:
                    try:
                        with trace.span("client.generate") as sp:
                            out = client.generate(**plan)
                        with lock:
                            results.append((plan, out))
                            if want_traces and getattr(sp, "trace_id", ""):
                                traces.append(sp.trace_id)
                    except ServingError as e:
                        with lock:
                            failures.append(str(e))

            t0 = _time.perf_counter()
            _fan_out(worker, plans, threads)
            wall_s = _time.perf_counter() - t0
            _time.sleep(3 * rcfg.probe_interval_s)  # let the prober publish
            prom = client.metrics_prom()
            health = client.healthz()
        scraped = _scrape_gauges(prom, ("router_prefix_hit_rate",))
        counters = _scrape_counters(
            prom, ("router_requests_total", "router_prefix_affinity_hit_total",
                   "router_spillover_total", "router_quarantines_total"))
        tokens = sum(len(o["tokens"]) for _, o in results)
        return {"replicas": n, "wall_s": wall_s, "tokens": tokens,
                "tokens_per_sec": tokens / wall_s if wall_s else 0.0,
                "completed": len(results), "failures": failures,
                "hit_rate": scraped.get("router_prefix_hit_rate", 0.0),
                "counters": counters, "results": results,
                "traces": traces, "health": health}

    single = one_leg(1, want_traces=False)
    multi = one_leg(replicas, want_traces=trace_out is not None)
    failures = single["failures"] + multi["failures"]

    # token parity, including spilled requests: every temperature-0
    # completion must equal the offline sample for its seed
    parity_checked = 0
    offline = _offline_params(model, params, scfg)
    for plan, out in multi["results"]:
        if plan["temperature"] != 0.0 or parity_checked >= 8:
            continue
        exp = _greedy(model, offline, plan["prompt"],
                      plan["max_new_tokens"], plan["seed"])
        if out["tokens"] != exp:
            failures.append(f"parity mismatch on replica {out['replica']} "
                            f"(spills={out['spills']})")
        parity_checked += 1

    trace_summary = None
    if trace_out is not None:
        TRACER.save_chrome_trace(trace_out)
        merged = _merge_trace(trace_out)
        by_trace: dict[str, set] = {}
        for ev in merged["traceEvents"]:
            tid = (ev.get("args") or {}).get("trace_id")
            if tid:
                by_trace.setdefault(tid, set()).add(ev["name"])
        need = {"router.request", "router.route", "serving.request",
                "serving.queue_wait", "serving.prefill", "serving.emit"}
        for tid in multi["traces"]:
            missing = need - by_trace.get(tid, set())
            if missing:
                failures.append(
                    f"trace {tid[:12]} missing spans {sorted(missing)}")
        routed_rows = _routed_requests(merged["traceEvents"])
        if not routed_rows:
            failures.append("trace_report shows no router hop on any request")
        trace_summary = {"path": trace_out,
                         "events": len(merged["traceEvents"]),
                         "requests_traced": len(multi["traces"]),
                         "routed_breakdown_rows": routed_rows}
    _guard_failures(guard, failures)

    reqs = multi["counters"].get("router_requests_total", 0.0)
    affinity = (multi["counters"].get("router_prefix_affinity_hit_total", 0.0)
                / reqs if reqs else 0.0)
    scaling = (multi["tokens_per_sec"] / single["tokens_per_sec"]
               if single["tokens_per_sec"] else 0.0)
    result = {
        "workload": "replicas",
        "requests": requests,
        "threads": threads,
        "seed": seed,
        "replicas": replicas,
        "page_size": page_size,
        "completed": multi["completed"],
        "single_hit_rate": single["hit_rate"],
        "aggregate_hit_rate": multi["hit_rate"],
        "prefix_affinity_rate": affinity,
        "spillover": multi["counters"].get("router_spillover_total", 0.0),
        "quarantines": multi["counters"].get("router_quarantines_total", 0.0),
        "single_tokens_per_sec": single["tokens_per_sec"],
        "tokens_per_sec": multi["tokens_per_sec"],
        "throughput_scaling": scaling,
        "parity_checked": parity_checked,
        "failures": failures[:5],
    }
    if trace_summary is not None:
        result["trace"] = trace_summary
    if guard is not None:
        result["lockguard_violations"] = len(guard.violations())
    assert not failures, failures[:5]
    assert single["completed"] == requests and multi["completed"] == requests
    assert parity_checked > 0, "no temperature-0 plans to parity-check"
    assert multi["hit_rate"] >= single["hit_rate"] - 0.05, (
        f"aggregate prefix hit rate {multi['hit_rate']:.3f} fell below the "
        f"single-replica run {single['hit_rate']:.3f} — affinity routing is "
        "shredding locality")
    assert affinity >= 0.9 - (result["spillover"] / max(reqs, 1.0)), (
        f"prefix affinity rate {affinity:.3f} too low for a healthy ring")
    return result


def run_slo(requests: int = 48, threads: int = 4, seed: int = 0,
            window_s: float = 2.0, ts_interval_s: float = 0.1, *,
            cfg=None, serving: dict | None = None, device=None) -> dict:
    """The ``--slo`` leg: the Zipf multi-tenant workload served while a
    :class:`TimeSeriesStore` samples the registry and an
    :class:`SLOEvaluator` watches ``default_serving_objectives`` over
    smoke-sized windows (``window_s`` and ``2*window_s`` instead of
    30/120 s).  The run holds the sampler alive until the short window
    is fully covered and FAILS unless at least one objective reaches a
    full window with a computed burn rate.  Burn rates land in the JSON
    line; with ``DL4J_TPU_TS_DIR`` set the samples also land as JSONL
    for ``tools/metrics_dump.py --timeline``."""
    import time as _time

    from .. import observability
    from ..device import resolve_device
    from ..observability import (METRICS, SLOEvaluator, TimeSeriesStore,
                                 default_serving_objectives)
    from ..serving import (InferenceEngine, ModelServer, ServingClient,
                           ServingConfig, ServingError)

    dev = resolve_device(device)
    observability.enable()
    METRICS.reset()

    cfg, model, params = _tiny_lm(cfg, dev, 7)
    rng = random.Random(seed)
    plans = _zipf_plans(rng, cfg.vocab_size, requests, 8)

    windows = (window_s, 2.0 * window_s)
    store = TimeSeriesStore(interval_s=ts_interval_s)
    evaluator = SLOEvaluator(default_serving_objectives(windows=windows),
                             store, breach_cooldown_s=windows[-1])

    failures: list[str] = []
    statuses: list[int] = []
    lock = threading.Lock()
    store.start()
    try:
        engine = InferenceEngine(model, params=params, cfg=_serving_cfg(
            ServingConfig(slots=4, resolve_every=4), serving), device=dev)
        with engine, ModelServer(engine=engine) as server:
            client = ServingClient(port=server.port)

            def worker(mine):
                for plan in mine:
                    try:
                        client.generate(**plan)
                        with lock:
                            statuses.append(200)
                    except ServingError as e:
                        with lock:
                            statuses.append(e.status)
                            failures.append(str(e))

            _fan_out(worker, plans, threads)
            # hold the sampler until the short window is fully covered —
            # a series only exists once its first request lands, so
            # anchor the hold to the workload's end, and the registry
            # keeps serving the last percentiles meanwhile
            deadline = _time.time() + windows[0] * 1.1
            while _time.time() < deadline:
                _time.sleep(ts_interval_s)
    finally:
        store.stop()

    status = evaluator.status()
    full_computed = sorted(
        name for name, burns in status["objectives"].items()
        if any(b["full"] and b["burn"] is not None for b in burns))
    snap = METRICS.snapshot()
    burn_rates = {k[len("slo.burn_rate."):]: v
                  for k, v in snap["gauges"].items()
                  if k.startswith("slo.burn_rate.")}
    ttft = snap["timers"].get("serving.ttft")
    result = {
        "workload": "slo",
        "requests": requests,
        "threads": threads,
        "seed": seed,
        "windows_s": list(windows),
        "completed": statuses.count(200),
        "rejected": len(statuses) - statuses.count(200),
        "samples": store.stats()["samples"],
        "evaluations": status["evaluations"],
        "burn_rates": burn_rates,
        "full_window_objectives": full_computed,
        "breaches": status["breaches"],
        "ttft_s": ({"p50": ttft["p50_s"], "p99": ttft["p99_s"],
                    "count": ttft["count"]} if ttft else None),
        "failures": failures[:5],
    }
    assert not failures, failures[:5]
    assert statuses.count(200) == requests
    assert status["evaluations"] > 0, "SLO evaluator never ran"
    assert full_computed, (
        "no objective reached a full window with a computed burn rate "
        f"(windows {windows}, {store.stats()['samples']} samples)")
    assert burn_rates, "no slo.burn_rate.* gauges published"
    return result


def _online_lm(cfg, dev, seed: int = 7):
    """The online legs' model: the reference's 1-layer, 16-wide one."""
    return _tiny_lm(cfg, dev, seed, vocab_size=32, d_model=16, n_heads=2,
                    n_layers=1, d_ff=32, max_len=32, xent_chunk=2048)


def run_online(requests: int = 24, threads: int = 3, seed: int = 0,
               rounds: int = 2, *, cfg=None, device=None) -> dict:
    """The ``--online`` leg: the full serve → capture → fine-tune →
    hot-reload dataflow over the HTTP surface.  Each round serves a wave
    of greedy requests through a ``ModelServer`` whose capture hook feeds
    a ``CaptureStore``, then runs one ``OnlineLoop`` round — replay,
    supervised fine-tune, checkpoint publish, canaried hot reload into
    the live engine.  The run FAILS unless every completed response's
    tokens match offline ``TransformerLM.sample`` under the checkpoint
    named by its OWN ``loaded_step`` stamp and at least one reload
    applied.  The JSON line carries the online metric tier
    (``online.generation``/``online.reloads``/``capture.bytes``/…)."""
    import tempfile
    import time as _time

    from .. import observability
    from ..device import resolve_device
    from ..observability import METRICS
    from ..online import CaptureStore, OnlineConfig, OnlineLoop
    from ..parallel.checkpoint import CheckpointManager
    from ..serving import (InferenceEngine, ModelServer, ServingClient,
                           ServingConfig, ServingError)

    dev = resolve_device(device)
    observability.enable()
    METRICS.reset()

    cfg, model, params0 = _online_lm(cfg, dev)
    rng = random.Random(seed)
    root = tempfile.mkdtemp(prefix="online-smoke-")
    store = CaptureStore(f"{root}/capture", segment_bytes=1 << 14)
    mgr = CheckpointManager(f"{root}/ckpt", keep=32)
    failures: list[str] = []
    served: list[dict] = []
    lock = threading.Lock()
    round_reports: list[dict] = []
    t0 = _time.time()

    engine = InferenceEngine(model, params=params0, checkpoint=mgr,
                             cfg=ServingConfig(slots=2, idle_wait_s=0.01),
                             device=dev)
    loop = OnlineLoop(store, mgr, model, params0=params0, engine=engine,
                      cfg=OnlineConfig(batch=2, seq=8))
    with engine, ModelServer(engine=engine, capture=store) as server:
        client = ServingClient(port=server.port)

        def worker(mine):
            for plan in mine:
                try:
                    out = client.generate(**plan)
                    with lock:
                        served.append({"plan": plan, "out": out})
                except ServingError as e:
                    with lock:
                        failures.append(f"request failed: {e}")

        per_round = max(1, requests // max(1, rounds))
        for _ in range(rounds):
            plans = [dict(prompt=[rng.randrange(cfg.vocab_size)
                                  for _ in range(rng.randint(2, 6))],
                          max_new_tokens=rng.randint(2, 8),
                          temperature=0.0, seed=rng.randrange(1 << 20))
                     for _ in range(per_round)]
            _fan_out(worker, plans, threads)
            round_reports.append(loop.run_once().to_dict())
    store.close()
    # generation-consistency audit: every completed response must match
    # offline sampling under the checkpoint its OWN stamp names
    restored_cache: dict = {None: params0}

    def params_at(step):
        if step not in restored_cache:
            restored_cache[step] = mgr.restore(params0, step=step)["params"]
        return restored_cache[step]

    for rec in served:
        plan, out = rec["plan"], rec["out"]
        exp = _greedy(model, params_at(out.get("loaded_step")),
                      plan["prompt"], len(out["tokens"]), plan["seed"])
        if out["tokens"] != exp:
            failures.append(
                f"generation-stamp parity: step {out.get('loaded_step')} "
                f"gen {out.get('generation')}: {out['tokens']} != {exp}")
    if not any(r["status"] == "ok" for r in round_reports):
        failures.append(f"no round applied a reload: {round_reports}")

    snap = METRICS.snapshot()
    gauges, counters = snap.get("gauges", {}), snap.get("counters", {})
    return {
        "ok": not failures,
        "failures": failures,
        "requests": len(served),
        "rounds": [r["status"] for r in round_reports],
        "generations": sorted({r["out"].get("generation") for r in served}),
        "online.generation": gauges.get("online.generation"),
        "online.reloads": counters.get("online.reloads", 0),
        "online.rollbacks": counters.get("online.rollbacks", 0),
        "online.captured_records": counters.get("online.captured_records", 0),
        "capture.bytes": gauges.get("capture.bytes"),
        "online.reload_seconds": gauges.get("online.reload_seconds"),
        "wall_s": _time.time() - t0,
    }


#: the process replicas' engine factory (a module path the child imports)
REPLICA_FACTORY = ("deeplearning4j_tpu_torch.serving.router.procserver"
                   ":tiny_lm_factory")


def run_fleet(requests: int = 36, threads: int = 6, seed: int = 0,
              replicas: int = 3, *, cfg=None, device=None) -> dict:
    """The ``--fleet`` leg: a Zipf multi-tenant workload over N process
    replicas (each with its own registry), federated by a
    :class:`FleetScraper` over the router's pool.

    Three contracts are asserted live:

    - **Exact federation**: the ``fleet.tokens_total`` rollup equals the
      sum of every replica's own ``serving.tokens`` counter equals the
      client-observed token total — token-for-token, no sampling slack.
    - **Exact tenancy**: every tenant's ``tenant.<t>.generated_tokens``,
      summed across replicas, equals the tokens the client watched that
      tenant receive.
    - **Graceful degradation**: SIGKILLing one replica mid-run costs
      ``fleet.scrape_errors`` plus a stale mark for THAT replica only,
      and its already-generated tokens stay in the counter rollup.

    A synthetic-ramp forecast phase then proves the ordering claim:
    ``forecast.time_to_breach.serving_ttft`` dumps its ``forecast_breach``
    bundle strictly before the ``SLOEvaluator`` records the breach
    (``{"fleet": {"scrape_ms": ...}}``).  ``cfg``'s sizes, when given,
    go to the replicas' factory (``REPLICA_FACTORY``)."""
    import tempfile
    import time as _time

    from .. import observability
    from ..device import resolve_device
    from ..observability import (METRICS, TENANTS, FleetScraper,
                                 ForecastEvaluator, MetricsRegistry,
                                 SLOEvaluator, SLObjective, TimeSeriesStore)
    from ..serving import (PrefixRouter, ProcessReplica, RouterConfig,
                           RouterServer, ServingClient, ServingError)

    dev = resolve_device(device)
    observability.enable()
    METRICS.reset()
    TENANTS.reset()

    rng = random.Random(seed)
    vocab, page_size = (cfg.vocab_size if cfg is not None else 64), 4
    tenants = ["acme", "globex", "initech", "umbrella"]
    zipf_w = [1.0 / (r + 1) ** 1.5 for r in range(len(tenants))]

    def make_plans(n: int) -> list[dict]:
        out = []
        for _ in range(n):
            t = rng.choices(tenants, weights=zipf_w)[0]
            out.append(dict(prompt=[rng.randrange(vocab)
                                    for _ in range(rng.randint(2, 10))],
                            max_new_tokens=rng.randint(1, 8),
                            temperature=rng.choice([0.0, 0.7]),
                            seed=rng.randrange(1 << 20), tenant=t))
        return out

    failures: list[str] = []
    observed: list[tuple[str, int]] = []      # (tenant, tokens delivered)
    lock = threading.Lock()
    workdir = tempfile.mkdtemp(prefix="fleet-smoke-")
    factory_kwargs = {"max_len": 32, "slots": 2, "paged": True,
                      "page_size": page_size, "prefix_cache": True,
                      "device": str(dev)}
    if cfg is not None:
        factory_kwargs.update({k: getattr(cfg, k) for k in (
            "vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
            "max_len")})
    reps = [ProcessReplica(f"p{i}", REPLICA_FACTORY, workdir,
                           factory_kwargs=factory_kwargs,
                           env={"OMP_NUM_THREADS": "1"},
                           client_timeout_s=30.0)
            for i in range(replicas)]
    router = PrefixRouter(reps, RouterConfig(
        page_size=page_size, affinity_pages=2, probe_interval_s=0.2,
        fail_threshold=2, recover_threshold=2))
    scraper = FleetScraper(router.pool, interval_s=0.25, timeout_s=5.0)

    def drive(plans):
        def worker(mine):
            for plan in mine:
                try:
                    out = client.generate(**plan)
                    with lock:
                        observed.append((plan["tenant"],
                                         len(out["tokens"])))
                except ServingError as e:
                    with lock:
                        failures.append(str(e))

        _fan_out(worker, plans, threads)

    with RouterServer(router) as server:
        client = ServingClient(port=server.port)
        scraper.start()
        drive(make_plans(requests // 2))
        _time.sleep(0.2)                   # let final evictions account
        scraper.scrape_once()              # all replicas alive + scraped
        live_before = dict(
            scraper.fed.values("serving.tokens", include_stale=True))
        if len(live_before) != replicas:
            failures.append(
                f"expected {replicas} federated replicas before the kill, "
                f"got {sorted(live_before)}")

        # chaos: SIGKILL one replica; scrapes must fail fast, mark ONLY
        # it stale, and keep its already-generated tokens in the rollup
        killed = reps[-1].name
        reps[-1].kill()
        t_kill = _time.perf_counter()
        scraper.scrape_once()
        kill_scrape_s = _time.perf_counter() - t_kill

        drive(make_plans(requests - requests // 2))
        _time.sleep(0.2)
        scraper.scrape_once()
        scraper.stop()
        snap = METRICS.snapshot()

        # per-replica ground truth: scrape the LIVE replicas directly
        # (the killed one's truth is its last federated value)
        per_replica: dict[str, float] = {}
        for rep in reps:
            if rep.name == killed:
                per_replica[rep.name] = live_before.get(killed, 0.0)
                continue
            body = rep.metrics_prom(timeout_s=5.0)
            per_replica[rep.name] = _scrape_counters(
                body, ("serving_tokens_total",)).get(
                    "serving_tokens_total", 0.0)
    router.close()

    client_tokens = sum(n for _, n in observed)
    fed_tokens = scraper.fed.values("serving.tokens", include_stale=True)
    fed_total = sum(fed_tokens.values())
    fleet_gauge = snap["gauges"].get("fleet.tokens_total")
    scrape_errors = snap["counters"].get("fleet.scrape_errors", 0.0)
    stale = scraper.fed.stale_replicas()
    client_by_tenant: dict[str, int] = {}
    for t, n in observed:
        client_by_tenant[t] = client_by_tenant.get(t, 0) + n
    fed_by_tenant = {
        t: sum(scraper.fed.values(f"tenant.{t}.generated_tokens",
                                  include_stale=True).values())
        for t in tenants}
    scrape_timer = snap["timers"].get("fleet.scrape")

    # ---- synthetic-ramp forecast phase: warning strictly before breach
    reg = MetricsRegistry()
    store = TimeSeriesStore(registry=reg)
    obj = SLObjective("serving_ttft", "upper", "serving.ttft.p99", 0.5,
                      budget=0.05, windows=(8.0, 16.0))
    slo = SLOEvaluator([obj], store, registry=reg, breach_cooldown_s=1e9)
    fore = ForecastEvaluator([obj], store, registry=reg, horizon_s=30.0,
                             window_s=8.0, min_samples=4,
                             breach_cooldown_s=1e9)
    t = 0.0
    while t <= 40.0:
        reg.gauge("serving.ttft.p99", 0.1 + 0.02 * t)   # crosses 0.5 @ t=20
        store.sample_once(t=t)
        t += 0.5
    warn_t = fore._last_warn_t.get("serving_ttft")
    breach_t = slo.breach_times.get("serving_ttft")
    forecast_led = (warn_t is not None and breach_t is not None
                    and warn_t < breach_t)

    result = {
        "workload": "fleet",
        "requests": requests,
        "threads": threads,
        "seed": seed,
        "replicas": replicas,
        "completed": len(observed),
        "client_tokens": client_tokens,
        "federated_tokens": fed_total,
        "fleet_tokens_total_gauge": fleet_gauge,
        "per_replica_tokens": per_replica,
        "killed_replica": killed,
        "kill_scrape_s": kill_scrape_s,
        "scrape_errors": scrape_errors,
        "stale_replicas": stale,
        "tenants_client": client_by_tenant,
        "tenants_federated": fed_by_tenant,
        "forecast_warn_t": warn_t,
        "slo_breach_t": breach_t,
        "forecast_breach_bundles": len(fore.warnings),
        "fleet": {"scrape_ms": (scrape_timer["mean_s"] * 1e3
                                if scrape_timer else None),
                  "scrapes": snap["counters"].get("fleet.scrapes", 0.0)},
        "failures": failures[:5],
    }
    assert not failures, failures[:5]
    assert len(observed) == requests, (
        f"only {len(observed)}/{requests} requests completed")
    assert fed_total == client_tokens, (
        f"federated token sum {fed_total} != client-observed "
        f"{client_tokens} — federation must be exact")
    assert fleet_gauge == sum(per_replica.values()) == client_tokens, (
        f"fleet.tokens_total {fleet_gauge} != per-replica sum "
        f"{sum(per_replica.values())} != client {client_tokens}")
    assert scrape_errors >= 1.0, "killed replica never counted as a scrape error"
    assert stale == [killed], (
        f"stale set {stale} != [{killed}] — only the killed replica may "
        "be marked stale")
    assert kill_scrape_s < 2 * scraper.timeout_s, (
        f"scrape after SIGKILL took {kill_scrape_s:.1f}s — must be "
        "bounded, never a hang")
    for t_name, n in client_by_tenant.items():
        assert fed_by_tenant.get(t_name) == n, (
            f"tenant {t_name}: federated {fed_by_tenant.get(t_name)} != "
            f"client-observed {n}")
    assert forecast_led, (
        f"forecast (warn_t={warn_t}) did not lead the SLO breach "
        f"(breach_t={breach_t})")
    assert fore.warnings, "no forecast_breach bundle was dumped"
    return result


def run_autoscale(seed: int = 0, requests: int = 24, threads: int = 4,
                  day_s: float = 86400.0, *, cfg=None,
                  device=None) -> dict:
    """The ``--autoscale`` leg, in two phases.

    **Real seams**: a scripted-signal :class:`Autoscaler` wired through
    ``router_actuators`` scales a live ``RouterServer`` pool 1 -> 2 -> 1.
    The scale-up replica warms BEFORE ring admission, the scale-down
    rides the quarantine drain path, and a fixed greedy probe must stay
    token-identical to offline ``TransformerLM.sample`` across every
    membership change.

    **Diurnal-plus-spike**: the same controller (real ``evaluate``/
    ``step`` logic, injected clock) runs over a deterministic fluid
    model of one simulated day — a diurnal sine plus an afternoon
    spike, fixed per-replica service rate, queue carried between
    windows.  The run FAILS unless the TTFT objective holds for >= 95%
    of simulated time while the autoscaler burns measurably fewer
    replica-hours than a static fleet provisioned for the peak
    (``{"autoscale": {"saved_frac": ...}}``).
    """
    import math

    from .. import observability
    from ..control import Autoscaler, AutoscalerConfig, ControlSignals
    from ..control.autoscaler import router_actuators
    from ..device import resolve_device
    from ..observability import METRICS
    from ..serving import (EngineReplica, InferenceEngine, PrefixRouter,
                           RouterConfig, RouterServer, ServingClient,
                           ServingConfig, ServingError)

    dev = resolve_device(device)
    observability.enable()
    METRICS.reset()
    rng = random.Random(seed)

    # ---- phase 1: the controller over the real router seams -------------
    cfg, model, params = _tiny_lm(cfg, dev, 7, max_len=32)
    scfg = ServingConfig(slots=2, resolve_every=2)

    def replica(name: str) -> EngineReplica:
        eng = InferenceEngine(model, params=params, cfg=scfg,
                              device=dev).start()
        return EngineReplica(name, eng, own_engine=True)

    probe = dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=8, temperature=0.0,
                 seed=0)
    expected = _greedy(model, _offline_params(model, params, scfg),
                       probe["prompt"], probe["max_new_tokens"])

    acfg = AutoscalerConfig(min_replicas=1, max_replicas=2, cooldown_s=10.0,
                            down_consecutive=2, warm_timeout_s=60.0,
                            drain_timeout_s=30.0)
    feed: list[ControlSignals] = []
    sim_t = [0.0]
    serial = [0]

    def factory() -> EngineReplica:
        serial[0] += 1
        return replica(f"a{serial[0]}")

    router = PrefixRouter([replica("a0")], RouterConfig(
        page_size=4, probe_interval_s=0.5, fail_threshold=2,
        recover_threshold=2))
    up, down, size = router_actuators(router, factory, acfg)
    scaler = Autoscaler(lambda: feed.pop(0), up, down, size, acfg,
                        clock=lambda: sim_t[0])

    failures: list[str] = []
    probes: list[list[int]] = []
    pool_sizes: list[int] = []
    lock = threading.Lock()

    def drive(client, n: int) -> None:
        plans = [dict(prompt=[rng.randrange(cfg.vocab_size)
                              for _ in range(rng.randint(2, 8))],
                      max_new_tokens=rng.randint(1, 6),
                      temperature=rng.choice([0.0, 0.7]),
                      seed=rng.randrange(1 << 20))
                 for _ in range(n)]

        def worker(mine):
            for plan in mine:
                try:
                    client.generate(**plan)
                except ServingError as e:
                    with lock:
                        failures.append(str(e))

        _fan_out(worker, plans, threads)

    def play(sig: ControlSignals) -> str | None:
        sim_t[0] += acfg.cooldown_s + 1.0
        feed.append(sig)
        return scaler.step()

    with RouterServer(router) as server:
        client = ServingClient(port=server.port)
        probes.append(client.generate(**probe)["tokens"])
        drive(client, requests // 3)
        pool_sizes.append(len(router.pool.names()))

        took_up = play(ControlSignals(burn=2.0, queue_depth=40))
        pool_sizes.append(len(router.pool.names()))
        probes.append(client.generate(**probe)["tokens"])
        drive(client, requests // 3)

        took_down = None
        for _ in range(acfg.down_consecutive + 1):
            took_down = play(ControlSignals(burn=0.0, queue_depth=0)) \
                or took_down
        pool_sizes.append(len(router.pool.names()))
        probes.append(client.generate(**probe)["tokens"])
        drive(client, requests - 2 * (requests // 3))

    snap = METRICS.snapshot()
    router.close()

    # ---- phase 2: diurnal + spike fluid model over one simulated day ----
    dt, cap, ttft_target = 60.0, 10.0, 1.0

    def lam(t: float) -> float:
        diurnal = 8.0 + 52.0 * (0.5 - 0.5 * math.cos(2 * math.pi * t / day_s))
        spike = 30.0 if 0.55 * day_s <= t < 0.62 * day_s else 0.0
        return diurnal + spike

    peak = max(lam(i * dt) for i in range(int(day_s / dt)))
    n_static = math.ceil(peak / cap)

    def simulate(elastic: bool) -> dict:
        state = {"n": n_static if not elastic else 2, "t": 0.0}
        fcfg = AutoscalerConfig(interval_s=dt, min_replicas=1,
                                max_replicas=n_static + 2, cooldown_s=2 * dt,
                                burn_up=1.0, burn_down=0.55, queue_high=50,
                                queue_low=5, down_consecutive=5)
        sig_box: list[ControlSignals] = [ControlSignals()]

        def bump(delta):
            def act():
                state["n"] += delta
            return act

        ctl = Autoscaler(lambda: sig_box[0], bump(+1), bump(-1),
                         lambda: state["n"], fcfg, clock=lambda: state["t"])
        q = replica_s = ok_s = 0.0
        actions = {"up": 0, "down": 0}
        for i in range(int(day_s / dt)):
            t = i * dt
            state["t"] = t
            n = state["n"]
            served = min(q + lam(t) * dt, n * cap * dt)
            q = max(0.0, q + lam(t) * dt - served)
            ttft = 0.05 + q / (n * cap)
            replica_s += n * dt
            ok_s += dt if ttft <= ttft_target else 0.0
            if elastic:
                # burn against an 80%-utilisation budget: queue growth is
                # the breach, sustained high utilisation is the warning
                sig_box[0] = ControlSignals(
                    burn=lam(t) / (n * cap) / 0.8, queue_depth=int(q))
                took = ctl.step()
                if took:
                    actions[took] += 1
        return {"replica_hours": replica_s / 3600.0,
                "ttft_ok_frac": ok_s / day_s,
                "scale_ups": actions["up"], "scale_downs": actions["down"],
                "final_n": state["n"]}

    elastic = simulate(elastic=True)
    static = simulate(elastic=False)
    saved = 1.0 - elastic["replica_hours"] / static["replica_hours"]

    result = {
        "workload": "autoscale",
        "seed": seed,
        "probe_parity": all(p == expected for p in probes),
        "pool_sizes": pool_sizes,
        "actions_real": [took_up, took_down],
        "router_scale_up": snap["counters"].get("router.scale_up", 0.0),
        "router_scale_down": snap["counters"].get("router.scale_down", 0.0),
        "control_scale_up": snap["counters"].get("control.scale_up", 0.0),
        "control_scale_down": snap["counters"].get("control.scale_down", 0.0),
        "failures": failures[:5],
        "static_peak_replicas": n_static,
        "elastic": elastic,
        "static": {k: static[k] for k in ("replica_hours", "ttft_ok_frac")},
        "autoscale": {"saved_frac": round(saved, 4),
                      "replica_hours": round(elastic["replica_hours"], 3),
                      "static_replica_hours": round(static["replica_hours"],
                                                    3)},
    }
    assert not failures, failures[:5]
    assert result["probe_parity"], (
        f"greedy probe diverged across scale events: {probes} != {expected}")
    assert pool_sizes == [1, 2, 1], (
        f"pool did not scale 1 -> 2 -> 1 through the real seams: "
        f"{pool_sizes} (actions {took_up!r}/{took_down!r})")
    assert took_up == "up" and took_down == "down", (took_up, took_down)
    assert result["router_scale_up"] >= 1.0 \
        and result["router_scale_down"] >= 1.0, snap["counters"]
    assert static["ttft_ok_frac"] == 1.0, (
        f"static-peak baseline itself breached TTFT: {static}")
    assert elastic["ttft_ok_frac"] >= 0.95, (
        f"autoscaler failed to hold the TTFT objective: {elastic}")
    assert elastic["scale_ups"] >= 2 and elastic["scale_downs"] >= 2, elastic
    assert saved >= 0.2, (
        f"autoscaling saved only {saved:.1%} replica-hours vs static peak "
        f"({elastic['replica_hours']:.1f}h vs {static['replica_hours']:.1f}h)")
    return result


def main(argv: list[str]) -> int:
    from ..device import resolve_device

    def arg(flag, default, cast=int):
        return cast(argv[argv.index(flag) + 1]) if flag in argv else default

    # the card unless --platform names another device; no card raises
    device = resolve_device(arg("--platform", "cuda", str))
    if "--online" in argv:
        out = run_online(requests=arg("--requests", 24),
                         threads=arg("--threads", 3),
                         seed=arg("--seed", 0),
                         rounds=arg("--rounds", 2), device=device)
        print(json.dumps(out))
        return 0 if out["ok"] else 1
    if "--autoscale" in argv:
        out = run_autoscale(seed=arg("--seed", 0),
                            requests=arg("--requests", 24),
                            threads=arg("--threads", 4), device=device)
        print(json.dumps(out))
        return 0
    if "--disagg" in argv:
        out = run_disagg(requests=arg("--requests", 24),
                         threads=arg("--threads", 3),
                         seed=arg("--seed", 0),
                         lockguard="--lockguard" in argv, device=device)
        print(json.dumps(out))
        return 0
    if "--fleet" in argv:
        out = run_fleet(requests=arg("--requests", 36),
                        threads=arg("--threads", 6),
                        seed=arg("--seed", 0),
                        replicas=arg("--replicas", 3), device=device)
    elif "--replicas" in argv:
        out = run_replicas(requests=arg("--requests", 48),
                           threads=arg("--threads", 8),
                           seed=arg("--seed", 0),
                           replicas=arg("--replicas", 4),
                           page_size=arg("--page-size", 6),
                           lockguard="--lockguard" in argv,
                           trace_out=arg("--trace-out", None, str),
                           strict_scaling="--strict-scaling" in argv,
                           device=device)
    elif "--slo" in argv:
        out = run_slo(requests=arg("--requests", 48),
                      threads=arg("--threads", 4),
                      seed=arg("--seed", 0),
                      window_s=arg("--window", 2.0, float), device=device)
    elif "--prefix-workload" in argv:
        out = run_prefix(requests=arg("--requests", 32),
                         threads=arg("--threads", 4),
                         seed=arg("--seed", 0),
                         page_size=arg("--page-size", 6),
                         lockguard="--lockguard" in argv,
                         kv_quant=arg("--kv-quant", None, str),
                         device=device)
    else:
        out = run(requests=arg("--requests", 32),
                  threads=arg("--threads", 4),
                  seed=arg("--seed", 0),
                  lockguard="--lockguard" in argv,
                  trace_out=arg("--trace-out", None, str), device=device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
