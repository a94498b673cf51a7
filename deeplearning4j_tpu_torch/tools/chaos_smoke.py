"""Chaos smoke: randomized fault injection against the training supervisor.

Port of ``tools/chaos_smoke.py``.  Draws a random fault plan (transient
step failure, corrupted checkpoint write, data-pipeline failure,
simulated preemption) from a seed — ``random.Random(seed)`` exactly as
the reference draws it, so one seed gives the same plan in both
packages — runs a short supervised fit under it, and asserts the run
COMPLETES with parameters bitwise identical to a fault-free reference.
One plan runs per ZeRO stage (0/1/2/3), each compared against the
replicated fault-free reference.  The data-parallel legs run SPMD over
``--world`` spawned gloo ranks (default 8, the reference's ``dp=8``;
ranks share the card on ``cuda``), started once per process and reused
by every stage and the elastic leg (``ranks.RankPool``).  The seed is
printed in the JSON result line, so any failing draw is replayable with
``python -m deeplearning4j_tpu_torch.tools.chaos_smoke --seed N [--stage
K]``.  ``--shardguard`` runs every leg — in this process and on every
rank — under the port's runtime sharding-drift detection
(``analysis.shardguard``) and fails on any violation.  The legs run on
the card unless ``--platform cpu`` is passed; without a card they raise.

A serving leg (``run_serving``) fires ``serving.request`` submission
faults and ``serving.decode`` dispatch skips, asserting completions stay
token-identical to the fault-free ``TransformerLM.sample`` reference
(``kv_quant="int8"``: a paged prefix-cache engine, greedy, >= 0.999
top-1 agreement), under the port's lockguard.

A disagg leg (``run_disagg``, ``--disagg --seed N``) kills prefill
workers before/after their prefill and aborts migrations with
decode-side claims held: every completion matches the offline
reference, every abort requeued, both pools' refcounts balance to zero
leaked pages.

An elastic leg (``run_elastic``, ``--elastic --seed N``): ``mesh.shrink``
takes 1-3 ranks out of the world mid-run (at least one survives),
sometimes handed back via ``mesh.grow``, sometimes with the resharding
restore failing once (``checkpoint.reshard``); training finishes on the
surviving mesh with every recovered loss within 1e-5 of the un-faulted
run and a ``mesh_resize`` flight bundle emitted.

An overload leg (``run_overload``, ``--overload --seed N``): the
brownout ladder up and down with greedy parity at every level, a tight
fair-share bucket that throttles only the noisy tenant, and a
``control.autoscaler`` chaos kill that freezes a real router pool.

An online leg (``run_online``, ``--online --seed N``): capture damage,
replay faults, fine-tune step failures, a poisoned publish, an aborted
reload and a failing rollback seam — every response matches offline
sampling under its OWN generation stamp, the poisoned checkpoint always
rolls back with a ``flightrec-online_rollback-*`` bundle, the loop heals.

Every supervised leg also audits the goodput accounting: the state
timeline is exhaustive, sums to independently measured wall-clock within
1%, and ``goodput.fraction`` strictly decreases versus the no-fault run
of the same seed.
"""

from __future__ import annotations

import json
import math
import random
import sys
import tempfile
import time

N_BATCHES = 8
BATCH = 8
#: this module, as the rank pool names its jobs
_JOBS = "deeplearning4j_tpu_torch.tools.chaos_smoke"
#: the process's rank pool (``_ranks``; ``main`` makes it under
#: ``--shardguard``)
_POOL: list = [None]


def _ranks(world: int, device):
    """The process's rank pool over ``world`` ranks on ``device``, started
    on first use and reused by every later leg of the same shape."""
    from .ranks import RankPool

    pool = _POOL[0]
    if pool is not None and (pool.world, pool.device) != (world, str(device)):
        pool.close()
        pool = None
    if pool is None:
        pool = _POOL[0] = RankPool(world, str(device))
    return pool


def close_ranks() -> None:
    """Stop the process's rank pool (the next multi-rank leg starts one)."""
    if _POOL[0] is not None:
        _POOL[0].close()
        _POOL[0] = None


def _run_on_ranks(world: int, device, job: str, *args) -> list:
    return _ranks(world, device).run(f"{_JOBS}:{job}", *args)


def _goodput_check(sup, ref_report: dict, measured_wall_s: float,
                   seed: int) -> dict:
    """Shared goodput acceptance: the supervised run's state timeline
    must be exhaustive over the documented states, sum to the
    independently measured wall-clock within 1%, and its productive
    fraction must be STRICTLY below the no-fault reference run of the
    same seed (faults cost wall-clock; the accounting must see it)."""
    from ..observability.goodput import STATES

    rep = sup.report.goodput
    assert rep is not None, f"seed {seed}: supervisor produced no goodput report"
    assert set(rep["states"]) <= set(STATES), rep["states"]
    acct, wall = rep["accounted_seconds"], rep["wall_seconds"]
    # timeline intervals are contiguous by construction: they must cover
    # the tracker's own wall exactly, and the tracker's wall must agree
    # with the clock we ran around the whole supervised fit
    assert abs(acct - wall) <= max(0.01 * wall, 1e-6), \
        f"seed {seed}: goodput timeline {acct:.4f}s != wall {wall:.4f}s"
    assert abs(acct - measured_wall_s) <= max(0.01 * measured_wall_s, 0.02), \
        (f"seed {seed}: goodput timeline {acct:.4f}s vs measured "
         f"wall {measured_wall_s:.4f}s (>1%)")
    overhead = sum(v for k, v in rep["seconds"].items() if k != "productive")
    assert rep["fraction"] < ref_report["fraction"], \
        (f"seed {seed}: goodput fraction {rep['fraction']:.4f} did not "
         f"decrease vs no-fault {ref_report['fraction']:.4f}")
    assert overhead > 0.0, f"seed {seed}: fault run accounted no overhead"
    return {
        "fraction": rep["fraction"],
        "ref_fraction": ref_report["fraction"],
        "seconds": {k: round(v, 6) for k, v in rep["seconds"].items()},
        "states": rep["states"],
        "wall_seconds": rep["wall_seconds"],
        "measured_wall_seconds": measured_wall_s,
    }


def _draw_plan(rng: random.Random):
    """A random-but-replayable fault plan over the supervised sites."""
    from ..resilience import FaultSpec

    specs = [
        FaultSpec("train.step", at_step=rng.randint(2, N_BATCHES)),
        # checkpoint_every=2 -> corrupt a write that actually happens
        FaultSpec("checkpoint.write",
                  at_step=2 * rng.randint(1, N_BATCHES // 2),
                  kind=rng.choice(["truncate", "bitflip"])),
    ]
    if rng.random() < 0.5:
        specs.append(FaultSpec("data.next", at_step=rng.randint(2, N_BATCHES)))
    if rng.random() < 0.5:
        specs.append(FaultSpec("preempt", at_step=rng.randint(2, N_BATCHES - 1)))
    return specs


def _plan_strings(plan) -> list[str]:
    return [f"{s.site}:at={s.at_step},kind={s.kind}" for s in plan]


class _Batch:
    def __init__(self, x, y):
        self.features, self.labels = x, y


def _regression():
    """The legs' data: ``y = x @ [1, -2, 0.5]`` over N_BATCHES batches of
    BATCH rows (``x`` from a numpy generator seeded 3, where the reference
    draws ``jax.random.normal(key(3))``), and its squared-error loss."""
    import numpy as np

    w_true = np.asarray([1.0, -2.0, 0.5], np.float32)
    xs = np.random.default_rng(3).standard_normal(
        (N_BATCHES * BATCH, 3), dtype=np.float32)
    ys = xs @ w_true
    data = [_Batch(xs[i * BATCH:(i + 1) * BATCH],
                   ys[i * BATCH:(i + 1) * BATCH]) for i in range(N_BATCHES)]

    def loss_fn(p, xb, yb, gen=None):
        return ((xb @ p["w"]) - yb).pow(2).mean()

    return data, loss_fn


def _rank_run(seed: int, zero_stage: int, plan, world: int, device: str,
              ckpt_dir: str) -> dict:
    """One rank of :func:`run`: the replicated fault-free fit, then the
    supervised fit at ``zero_stage`` under ``plan``."""
    import numpy as np
    import torch

    from .. import observability
    from ..observability import METRICS, GoodputTracker
    from ..optimize import transforms as T
    from ..parallel import DataParallelTrainer
    from ..parallel.checkpoint import CheckpointManager
    from ..parallel.mesh import MeshSpec, make_mesh, rank_devices, world_rank
    from ..resilience import RetryPolicy, TrainingSupervisor, inject_faults
    from ..resilience.faults import FAULTS
    from ..utils.tree_math import tree_leaves

    observability.enable()
    METRICS.reset()
    FAULTS.disarm()
    data, loss_fn = _regression()

    def new_trainer(stage=zero_stage):
        mesh = make_mesh(MeshSpec(dp=world), devices=rank_devices()[:world])
        return DataParallelTrainer(loss_fn, T.chain(T.momentum(0.9),
                                                    T.sgd_lr(5e-2)),
                                   mesh=mesh, zero_stage=stage, device=device)

    params = {"w": np.zeros(3, np.float32)}
    # the fault-free reference always runs REPLICATED (stage 0): the chaos
    # claim under ZeRO is recovery parity against classic numerics, not
    # just against another sharded run
    t_ref = new_trainer(stage=0)
    gp_ref = GoodputTracker()
    s_ref, ref_losses = t_ref.fit(t_ref.init_state(params), data, epochs=1,
                                  goodput=gp_ref)
    ref_goodput = gp_ref.finish()

    mgr = CheckpointManager(ckpt_dir, keep=10)
    with inject_faults(*plan, seed=seed):
        sup = TrainingSupervisor(
            mgr, RetryPolicy(max_attempts=8, backoff_base_s=0.01),
            install_signal_handlers=False)
        trainer = new_trainer()
        t_wall = time.monotonic()
        state, losses = sup.fit(trainer, params, data, epochs=1,
                                checkpoint_every=2)
        wall_s = time.monotonic() - t_wall

    # compare NATURAL layouts: under zero_stage=3 state.params are the
    # flat dp-sharded chunks, so collapse both sides via final_params
    params_equal = all(
        torch.equal(a.cpu(), b.cpu())
        for a, b in zip(tree_leaves(t_ref.final_params(s_ref)),
                        tree_leaves(trainer.final_params(state))))
    # losses from aborted attempts die with the pending ring, leaving
    # gaps, so align by STEP: every loss a successful attempt resolved
    # must match the reference loss at the same step exactly
    by_step = sup.report.losses_by_step
    loss_parity = all(v == ref_losses[s - 1] for s, v in by_step.items())
    counters = METRICS.snapshot()["counters"]
    return {
        "seed": seed,
        "zero_stage": zero_stage,
        "world": world,
        "plan": _plan_strings(plan),
        "final_step": int(state.step),
        "ref_step": int(s_ref.step),
        "params_bitwise_equal": params_equal,
        "loss_parity": loss_parity,
        "losses_recovered": len(by_step),
        "losses_finite": all(math.isfinite(v) for v in losses),
        "attempts": sup.report.attempts,
        "retries": sup.report.retries,
        "preemptions": sup.report.preemptions,
        "resumed_from": sup.report.resumed_from,
        "faults_injected": {k: int(v) for k, v in counters.items()
                            if k.startswith("faults.injected.")},
        "corrupt_detected": int(counters.get("checkpoint.corrupt_detected",
                                             0)),
        "goodput": (_goodput_check(sup, ref_goodput, wall_s, seed)
                    if world_rank() == 0 else None),
    }


def run(seed: int | None = None, zero_stage: int = 0, *, world: int = 8,
        device=None) -> dict:
    """One supervised chaos fit at ``zero_stage`` over ``world`` ranks
    against the replicated fault-free fit (rank 0's result; every rank
    must agree on the step and on bitwise parameter equality)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if seed is None:
        seed = random.SystemRandom().randrange(2 ** 31)
    rng = random.Random(seed)
    plan = _draw_plan(rng)
    with tempfile.TemporaryDirectory(prefix="chaos-ckpt-") as ckpt_dir:
        outs = _run_on_ranks(world, dev, "_rank_run", seed, zero_stage, plan,
                             world, str(dev), ckpt_dir)
    result = outs[0]
    assert all(o["final_step"] == result["final_step"]
               and o["params_bitwise_equal"] for o in outs), \
        f"seed {seed}: ranks disagree: {[o['final_step'] for o in outs]}"
    assert result["final_step"] == result["ref_step"], \
        f"seed {seed}: chaos run stopped at step {result['final_step']}"
    assert result["params_bitwise_equal"], \
        f"seed {seed}: parameters diverged from reference"
    assert result["loss_parity"], f"seed {seed}: recovered losses diverged"
    assert result["faults_injected"], f"seed {seed}: plan never fired"
    return result


def _chaos_lm(cfg, dev, seed: int = 11, **over):
    from .serving_smoke import _tiny_lm

    return _tiny_lm(cfg, dev, seed, **over)


def run_serving(seed: int, kv_quant: str | None = None, *, cfg=None,
                device=None) -> dict:
    """Chaos leg for the serving subsystem: fire ``serving.request`` at a
    random submit index and ``serving.decode`` for a random number of
    decode rounds, and assert every completion is STILL token-identical
    to the fault-free ``TransformerLM.sample`` reference — the engine's
    skip-and-retry contract (a skipped dispatch leaves state untouched).

    With ``kv_quant`` set the same dice roll runs against a paged +
    prefix-cache engine with quantized KV pages and ALL-greedy requests:
    exact parity relaxes to the >= 0.999 served-token top-1 agreement
    floor, so fault-driven retry/skip paths are exercised through the
    quantized write path too.

    The whole leg runs under the port's lockguard: injected faults drive
    the engine's error paths (submit retry, decode skip, eviction on
    failure) — any lock-order inversion or unguarded shared write
    observed fails the leg alongside the parity assertion."""
    from .. import observability
    from ..analysis.lockguard import LockGuard
    from ..device import resolve_device
    from ..observability import METRICS
    from ..resilience import FaultSpec, inject_faults
    from ..resilience.faults import FAULTS, InjectedFault
    from ..serving import InferenceEngine, ServingConfig
    from .serving_smoke import _sharpen

    dev = resolve_device(device)
    rng = random.Random(seed + 1)
    observability.enable()
    METRICS.reset()

    cfg, model, params = _chaos_lm(cfg, dev, max_len=32)
    # quantized KV holds a top-1 agreement floor, not bitwise parity —
    # meaningful only for greedy decoding, so the int8 leg pins temp to 0
    # and sharpens the model so margins measure the quantizer, not init
    # noise (see serving_smoke._sharpen)
    temps = [0.0, 0.8]
    if kv_quant is not None:
        params = _sharpen(model, params, cfg)
        temps = [0.0]
    reqs = [dict(prompt=[rng.randrange(cfg.vocab_size)
                         for _ in range(rng.randint(1, 10))],
                 max_new_tokens=rng.randint(1, 8),
                 temperature=rng.choice(temps),
                 seed=rng.randrange(1 << 16))
            for _ in range(5)]
    expected = [model.sample(params, r["prompt"], r["max_new_tokens"],
                             temperature=r["temperature"], seed=r["seed"],
                             kv_cache=True)[len(r["prompt"]):]
                for r in reqs]

    decode_fires = rng.randint(1, 3)
    submit_fire_at = rng.randint(1, len(reqs))
    specs = [FaultSpec("serving.decode", probability=1.0,
                       max_fires=decode_fires),
             FaultSpec("serving.request", at_step=submit_fire_at)]
    submit_faults = 0
    scfg = (ServingConfig(slots=3, resolve_every=2) if kv_quant is None
            else ServingConfig(slots=3, resolve_every=2, paged=True,
                               page_size=4, prefix_cache=True,
                               kv_quant=kv_quant))
    guard = LockGuard().install()
    try:
        with inject_faults(*specs, seed=seed):
            engine = InferenceEngine(model, params=params, cfg=scfg,
                                     device=dev).start()
            handles = []
            for r in reqs:
                try:
                    handles.append(engine.submit(**r))
                except InjectedFault:
                    submit_faults += 1
                    handles.append(engine.submit(**r))  # transient: retry wins
            outs = [h.result(60.0) for h in handles]
            engine.stop()
            fired = {"serving.decode": FAULTS.fire_count("serving.decode"),
                     "serving.request": FAULTS.fire_count("serving.request")}
    finally:
        guard.uninstall()

    parity = all(o.tokens == e for o, e in zip(outs, expected))
    total = sum(len(e) for e in expected)
    agree = sum(1 for o, e in zip(outs, expected)
                for x, y in zip(o.tokens, e) if x == y)
    agreement = agree / total if total else 0.0
    result = {
        "seed": seed,
        "requests": len(reqs),
        "kv_quant": kv_quant,
        "token_parity_under_faults": parity,
        "token_agreement_under_faults": agreement,
        "decode_faults_fired": fired["serving.decode"],
        "submit_faults_fired": fired["serving.request"],
        "submit_retries": submit_faults,
        "lockguard_violations": len(guard.violations()),
    }
    if kv_quant is None:
        assert parity, f"seed {seed}: served tokens diverged under injection"
    else:
        assert agreement >= 0.999, (
            f"seed {seed}: kv_quant={kv_quant} token agreement "
            f"{agreement:.4f} under the 0.999 floor")
    assert fired["serving.decode"] == decode_fires, result
    assert fired["serving.request"] == 1 and submit_faults == 1, result
    assert not guard.violations(), guard.report()
    return result


def run_disagg(seed: int, *, cfg=None, device=None) -> dict:
    """Chaos leg for the disaggregated tier: fire
    ``disagg.prefill_worker`` (a prefill worker dies before or after its
    prefill ran) and ``disagg.migrate`` (the page transfer aborts
    mid-flight, decode-side claims already held) at random draw points
    while a batch of requests streams through prefill + migration +
    decode, and assert the tier's whole failure contract at once: every
    completion is STILL token-identical to the fault-free
    ``TransformerLM.sample`` reference (a killed migration only ever
    REQUEUES), the requeue counter saw every abort, and after the dust
    settles both pools' refcounts balance — zero leaked pages.  Runs
    under the port's lockguard."""
    from .. import observability
    from ..analysis.lockguard import LockGuard
    from ..device import resolve_device
    from ..observability import METRICS
    from ..resilience import FaultSpec, inject_faults
    from ..resilience.faults import FAULTS
    from ..serving import DisaggScheduler, InferenceEngine, ServingConfig

    dev = resolve_device(device)
    rng = random.Random(seed + 6)
    observability.enable()
    METRICS.reset()

    cfg, model, params = _chaos_lm(cfg, dev)

    def mk(role):
        return InferenceEngine(
            model, params=params,
            cfg=ServingConfig(slots=4, resolve_every=4, max_queue=64,
                              paged=True, page_size=8, prefix_cache=True,
                              role=role), device=dev)

    reqs = [dict(prompt=[rng.randrange(cfg.vocab_size)
                         for _ in range(rng.randint(2, 12))],
                 max_new_tokens=rng.randint(1, 8),
                 temperature=rng.choice([0.0, 0.8]),
                 seed=rng.randrange(1 << 16))
            for _ in range(6)]
    expected = [model.sample(params, r["prompt"], r["max_new_tokens"],
                             temperature=r["temperature"], seed=r["seed"],
                             kv_cache=True)[len(r["prompt"]):]
                for r in reqs]

    # the worker site fires twice per attempt (before and after the
    # prefill), the migrate site twice per migration — draw the abort
    # points so both "nothing acquired yet" and "claims held" unwind
    # paths get exercised across seeds
    worker_fires = rng.randint(1, 2)
    specs = [FaultSpec("disagg.prefill_worker",
                       at_step=rng.randint(1, 4), max_fires=worker_fires),
             FaultSpec("disagg.migrate",
                       at_step=rng.randint(1, 6), max_fires=1)]

    guard = LockGuard().install()
    pf = mk("prefill")
    dec = mk("decode")
    try:
        with inject_faults(*specs, seed=seed):
            sched = DisaggScheduler([pf], dec).start()
            try:
                pendings = [sched.submit(**r) for r in reqs]
                outs = [p.result(120.0) for p in pendings]
                fired = {s.site: FAULTS.fire_count(s.site) for s in specs}
                time.sleep(0.3)      # let abandoned-ticket unwinds land
                # zero-leak audit: drop the prefix-cache pins (the only
                # legitimate surviving references) and every page must
                # return to the free list with refcounts balanced
                leaks = {}
                for name, pool in (("prefill", pf.page_pool),
                                   ("decode", dec.page_pool)):
                    pool.requeue(pool.clear_prefix())
                    leaks[name] = (pool.num_pages - pool.free_count(),
                                   sum(pool.refcounts()))
            finally:
                sched.stop()
    finally:
        guard.uninstall()

    requeues = METRICS.snapshot()["counters"].get("disagg.requeues", 0.0)
    parity = all(o.tokens == e for o, e in zip(outs, expected))
    result = {
        "seed": seed,
        "requests": len(reqs),
        "token_parity_under_faults": parity,
        "worker_faults_fired": fired["disagg.prefill_worker"],
        "migrate_faults_fired": fired["disagg.migrate"],
        "requeues": requeues,
        "leaked_pages": leaks,
        "lockguard_violations": len(guard.violations()),
    }
    assert parity, f"seed {seed}: migrated tokens diverged under injection"
    total_fired = fired["disagg.prefill_worker"] + fired["disagg.migrate"]
    assert total_fired >= 1, result
    assert requeues >= total_fired, (
        f"seed {seed}: {total_fired} aborts but only {requeues} requeues "
        "— a killed migration was not requeued", result)
    assert leaks == {"prefill": (0, 0), "decode": (0, 0)}, (
        f"seed {seed}: leaked pages after chaos: {leaks}")
    assert not guard.violations(), guard.report()
    return result


def _rank_elastic(seed: int, stage: int, plan, world: int, device: str,
                  root: str) -> dict:
    """One rank of :func:`run_elastic`: the un-faulted fit at full width,
    then the supervised fit over a trainer factory under ``plan``."""
    import pathlib

    import numpy as np

    from .. import observability
    from ..observability import FLIGHTREC, METRICS, GoodputTracker
    from ..optimize import transforms as T
    from ..parallel import DataParallelTrainer, elastic_mesh
    from ..parallel.checkpoint import CheckpointManager
    from ..parallel.mesh import rank_devices, world_rank
    from ..resilience import RetryPolicy, TrainingSupervisor, inject_faults
    from ..resilience.faults import FAULTS

    observability.enable()
    METRICS.reset()
    FAULTS.disarm()
    data, loss_fn = _regression()

    def factory(devices):
        devs = devices if devices is not None else rank_devices()[:world]
        return DataParallelTrainer(loss_fn, T.chain(T.momentum(0.9),
                                                    T.sgd_lr(5e-2)),
                                   mesh=elastic_mesh(devs), zero_stage=stage,
                                   device=device)

    params = {"w": np.zeros(3, np.float32)}
    t_ref = factory(None)
    gp_ref = GoodputTracker()
    s_ref, ref_losses = t_ref.fit(t_ref.init_state(params), data, epochs=1,
                                  goodput=gp_ref)
    ref_goodput = gp_ref.finish()

    rec_dir = pathlib.Path(root) / f"rec{world_rank()}"
    old_dump_dir = FLIGHTREC.dump_dir
    FLIGHTREC.dump_dir = rec_dir
    try:
        mgr = CheckpointManager(pathlib.Path(root) / "ckpt", keep=10)
        with inject_faults(*plan, seed=seed):
            sup = TrainingSupervisor(
                mgr, RetryPolicy(max_attempts=8, backoff_base_s=0.01),
                install_signal_handlers=False)
            t_wall = time.monotonic()
            state, losses = sup.fit(factory, params, data, epochs=1,
                                    checkpoint_every=2)
            wall_s = time.monotonic() - t_wall
        bundles = sorted(p.name for p in
                         rec_dir.glob("flightrec-mesh_resize-*"))
    finally:
        FLIGHTREC.dump_dir = old_dump_dir

    by_step = sup.report.losses_by_step
    window = max((abs(v - ref_losses[s - 1]) for s, v in by_step.items()),
                 default=0.0)
    counters = METRICS.snapshot()["counters"]
    return {
        "seed": seed,
        "zero_stage": stage,
        "world": world,
        "plan": _plan_strings(plan),
        "final_step": int(state.step),
        "ref_step": int(s_ref.step),
        "final_mesh_size": int(sup.trainer.mesh.devices.size),
        "mesh_sizes": list(sup.report.mesh_sizes),
        "resizes": sup.report.resizes,
        "loss_window": float(window),
        "losses_recovered": len(by_step),
        "losses_finite": all(math.isfinite(v) for v in losses),
        "mesh_resize_bundles": bundles,
        "reshard_restores": int(counters.get("checkpoint.reshards", 0)),
        "faults_injected": {k: int(v) for k, v in counters.items()
                            if k.startswith("faults.injected.")},
        "goodput": (_goodput_check(sup, ref_goodput, wall_s, seed)
                    if world_rank() == 0 else None),
    }


def run_elastic(seed: int, *, world: int = 8, device=None) -> dict:
    """Chaos leg for the elasticity tier: kill 1-3 ranks out of the
    ``world``-rank mesh mid-run (``mesh.shrink``; at least one survives),
    sometimes hand them back later (``mesh.grow``), sometimes make the
    resharding restore itself fail once (``checkpoint.reshard``), and
    assert the supervised run COMPLETES on the surviving mesh with every
    recovered loss inside the elastic window (|loss - ref| <= 1e-5 across
    dp widths: the all-reduce's association order changes with the
    width, so cross-width parity is a window, not bitwise) and a
    ``mesh_resize`` flight bundle emitted (rank 0's result)."""
    from ..device import resolve_device
    from ..resilience import FaultSpec

    dev = resolve_device(device)
    rng = random.Random(seed + 2)
    stage = rng.choice([0, 1, 2, 3])
    lost_chips = rng.randint(1, 3)
    shrink_at = rng.randint(2, N_BATCHES - 2)
    plan = [FaultSpec("mesh.shrink", at_step=shrink_at, kind=str(lost_chips))]
    grow = rng.random() < 0.5
    if grow:
        plan.append(FaultSpec("mesh.grow", at_step=rng.randint(
            shrink_at + 1, N_BATCHES - 1)))
    if rng.random() < 0.5:
        # the reshard itself dies once mid-flight; the supervisor's retry
        # budget must absorb it
        plan.append(FaultSpec("checkpoint.reshard", probability=1.0,
                              max_fires=1))
    with tempfile.TemporaryDirectory(prefix="chaos-elastic-") as root:
        result = _run_on_ranks(world, dev, "_rank_elastic", seed, stage,
                               plan, world, str(dev), root)[0]

    assert result["final_step"] == result["ref_step"], \
        f"seed {seed}: elastic run stopped at step {result['final_step']}"
    expect_mesh = world if grow else world - lost_chips
    assert result["final_mesh_size"] == expect_mesh, \
        (f"seed {seed}: final mesh {result['final_mesh_size']}, expected "
         f"{expect_mesh}")
    assert result["mesh_sizes"][0] == world - lost_chips, result["mesh_sizes"]
    # the elastic window: cross-width reduction order shifts float32
    # losses by O(1e-6); 1e-5 bounds it with margin
    assert result["loss_window"] <= 1e-5, \
        f"seed {seed}: loss window {result['loss_window']:.3e} > 1e-5"
    assert result["mesh_resize_bundles"], \
        f"seed {seed}: no mesh_resize flight bundle emitted"
    assert result["faults_injected"].get("faults.injected.mesh.shrink", 0) \
        or result["faults_injected"], result
    return result


def run_online(seed: int, *, cfg=None, device=None) -> dict:
    """Chaos leg for the online learning loop: serve real traffic through
    a capture-hooked ``ModelServer``, then roll the dice across the
    loop's whole dataflow — ``capture.write`` damages the active segment
    mid-wave, ``capture.replay`` kills a round at replay, ``train.step``
    (and sometimes ``preempt``) fail the fine-tune, ``online.publish
    kind="poison"`` rewrites the published params with NaNs under
    *recomputed* checksums, ``online.reload`` aborts a swap, and
    ``online.rollback`` fails inside the recovery path itself.

    Acceptance: (a) every completed response's tokens match offline
    ``TransformerLM.sample`` under the checkpoint named by its OWN
    ``loaded_step`` stamp; (b) the faulted fine-tune's goodput timeline
    passes the shared audit; (c) the poisoned checkpoint ALWAYS rolls
    back — quarantined, an ``online_rollback`` flight bundle, serving
    back on the previous valid generation — and a later round
    republishes cleanly and reloads it (the loop heals itself)."""
    import pathlib

    from .. import observability
    from ..device import resolve_device
    from ..models.transformer import lm_loss_local
    from ..observability import FLIGHTREC, METRICS, GoodputTracker
    from ..online import CaptureStore, OnlineConfig, OnlineLoop
    from ..optimize import transforms as T
    from ..parallel import DataParallelTrainer
    from ..parallel.checkpoint import CheckpointManager
    from ..parallel.mesh import local_mesh
    from ..resilience import FaultSpec, inject_faults
    from ..serving import (InferenceEngine, ModelServer, ServingClient,
                           ServingConfig)
    from .serving_smoke import _online_lm

    dev = resolve_device(device)
    rng = random.Random(seed + 3)
    observability.enable()
    METRICS.reset()

    cfg, model, params0 = _online_lm(cfg, dev)
    root = tempfile.mkdtemp(prefix="online-chaos-")
    # tiny segments so the damaged-medium fault lands on a rotating store
    store = CaptureStore(f"{root}/capture", segment_bytes=1024)
    mgr = CheckpointManager(f"{root}/ckpt", keep=64)
    # canary_factor=10: the poison is NaN (caught at ANY factor); a tight
    # regression factor would let fault-shifted replay streams flake the
    # scripted heal sequence with false-positive rollbacks
    ocfg = OnlineConfig(batch=2, seq=8, canary_factor=10.0)
    engine = InferenceEngine(model, params=params0, checkpoint=mgr,
                             cfg=ServingConfig(slots=2, idle_wait_s=0.01),
                             device=dev)
    loop = OnlineLoop(store, mgr, model, params0=params0, engine=engine,
                      cfg=ocfg)

    # time each supervised fit from outside, exactly as the other legs
    # wrap sup.fit — the goodput audit compares the tracker's own wall
    # against this independent clock
    fit_walls: list[float] = []
    orig_fit = loop.supervisor.fit

    def timed_fit(*a, **k):
        t0 = time.monotonic()
        try:
            return orig_fit(*a, **k)
        finally:
            fit_walls.append(time.monotonic() - t0)

    loop.supervisor.fit = timed_fit

    served: list[dict] = []

    def wave(client, n):
        for _ in range(n):
            req = dict(prompt=[rng.randrange(cfg.vocab_size)
                               for _ in range(rng.randint(2, 6))],
                       max_new_tokens=rng.randint(2, 8),
                       temperature=0.0, seed=rng.randrange(1 << 20))
            served.append({"req": req, "out": client.generate(**req)})

    reports: list[dict] = []
    goodput = None
    rec_dir = tempfile.mkdtemp(prefix="online-chaos-rec-")
    old_dump_dir = FLIGHTREC.dump_dir
    FLIGHTREC.dump_dir = pathlib.Path(rec_dir)
    try:
        with engine, ModelServer(engine=engine, capture=store) as server:
            client = ServingClient(port=server.port)
            # warm round, fault-free: captures wave 1, fine-tunes,
            # publishes, hot-reloads — so the chaos round's goodput
            # measures recovery, not first-call costs
            wave(client, 12)
            rep = loop.run_once().to_dict()
            reports.append(rep)
            assert rep["status"] == "ok", \
                f"seed {seed}: fault-free warm round failed: {rep}"
            base_step = mgr.latest_valid_step()

            # fault-free goodput reference: the same replayed stream
            # through the same trainer construction, no checkpointing
            batches0 = loop._pack(list(store.replay()))

            def loss_fn(p, xb, yb, gen=None):
                return lm_loss_local(p, xb, yb, model.cfg)

            t_ref = DataParallelTrainer(loss_fn, T.sgd_lr(ocfg.learning_rate),
                                        mesh=local_mesh(1), device=dev)
            gp_ref = GoodputTracker()
            t_ref.fit(t_ref.init_state(params0), batches0, epochs=1,
                      goodput=gp_ref)
            ref_goodput = gp_ref.finish()

            plan = [
                # fails the fine-tune 1-3 steps past the warm checkpoint
                FaultSpec("train.step",
                          at_step=base_step + rng.randint(1, 3)),
                # damages the active capture segment under a wave-2 append
                FaultSpec("capture.write", at_step=rng.randint(1, 12),
                          kind=rng.choice(["truncate", "bitflip"])),
                # the first publish after the warm round is poisoned
                FaultSpec("online.publish", at_step=1, kind="poison"),
                # ...and after its rollback, the republish's reload aborts
                FaultSpec("online.reload", at_step=2),
                # rollback's own seam fails once inside recovery
                FaultSpec("online.rollback", at_step=1),
            ]
            if rng.random() < 0.5:
                plan.append(FaultSpec("capture.replay", at_step=1))
            if rng.random() < 0.5:
                plan.append(FaultSpec("preempt",
                                      at_step=base_step + rng.randint(1, 3)))
            with inject_faults(*plan, seed=seed):
                wave(client, 16)
                walls_before = len(fit_walls)
                for _ in range(8):
                    rep = loop.run_once().to_dict()
                    reports.append(rep)
                    counters = METRICS.snapshot()["counters"]
                    if (goodput is None and len(fit_walls) > walls_before
                            and counters.get("faults.injected.train.step")):
                        # this round ran the fit the step fault hit; audit
                        # its report before a later round's fit replaces it
                        goodput = _goodput_check(loop.supervisor, ref_goodput,
                                                 fit_walls[-1], seed)
                    if rep["status"] == "ok":
                        break
            # post-chaos traffic decodes under the healed generation
            wave(client, 6)
        bundles = sorted(p.name for p in
                         pathlib.Path(rec_dir).glob("*online_rollback*"))
    finally:
        FLIGHTREC.dump_dir = old_dump_dir
    store.close()

    # generation-consistency audit: every response across ALL waves must
    # match offline sampling under the checkpoint its OWN stamp names
    restored_cache: dict = {None: params0}

    def params_at(step):
        if step not in restored_cache:
            restored_cache[step] = mgr.restore(params0, step=step)["params"]
        return restored_cache[step]

    parity_failures = []
    for rec in served:
        req, out = rec["req"], rec["out"]
        exp = model.sample(params_at(out.get("loaded_step")), req["prompt"],
                           len(out["tokens"]), temperature=0.0,
                           seed=req["seed"], kv_cache=True)[len(req["prompt"]):]
        if out["tokens"] != exp:
            parity_failures.append(
                f"step {out.get('loaded_step')} gen {out.get('generation')}: "
                f"{out['tokens']} != {exp}")

    rolled = [r for r in reports if r["rolled_back"]]
    counters = METRICS.snapshot()["counters"]
    result = {
        "seed": seed,
        "plan": _plan_strings(plan),
        "base_step": base_step,
        "requests": len(served),
        "rounds": [r["status"] for r in reports],
        "generation": loop.generation,
        "loaded_step": engine.stats()["loaded_step"],
        "token_parity_at_stamped_generation": not parity_failures,
        "parity_failures": parity_failures,
        "rollbacks": [{"reason": r["rollback_reason"],
                       "quarantined": r["quarantined"]} for r in rolled],
        "rollback_bundles": bundles,
        "captured_records": int(counters.get("online.captured_records", 0)),
        "corrupt_records": int(counters.get("capture.corrupt_records", 0)),
        "faults_injected": {k: int(v) for k, v in counters.items()
                            if k.startswith("faults.injected.")},
        "goodput": goodput,
    }
    assert not parity_failures, \
        f"seed {seed}: stamped-generation parity broke: {parity_failures}"
    assert rolled and all(r["rollback_reason"] == "canary_nonfinite"
                          and r["quarantined"] for r in rolled), \
        f"seed {seed}: poisoned publish did not roll back: {reports}"
    assert bundles, f"seed {seed}: rollback emitted no flight bundle"
    assert reports[-1]["status"] == "ok", \
        f"seed {seed}: loop never healed after the chaos: {reports}"
    assert engine.stats()["loaded_step"] == \
        reports[-1]["reloaded"].get("engine"), \
        f"seed {seed}: engine not on the healed generation: {reports[-1]}"
    assert goodput is not None, \
        f"seed {seed}: train.step never hit a fine-tune round: {reports}"
    assert result["faults_injected"].get("faults.injected.online.publish"), \
        result
    return result


def run_overload(seed: int, *, cfg=None, device=None) -> dict:
    """Chaos leg for the control plane, in three phases.

    **Brownout ladder**: a speculative engine is walked up the full
    ladder (healthy -> spec off -> ``max_new`` clamped -> background
    shed) by a burn-rate feed and back down one rung at a time.  At
    EVERY level each served greedy completion must be token-identical
    to the fault-free ``TransformerLM.sample`` reference under that
    level's effective budget.  At level 3 background submissions must
    429 while interactive ones keep parity; after descent the engine
    must be speculative again with full-length parity.

    **Fair share**: a tight per-tenant token bucket is installed; the
    noisy tenant exhausts its OWN bucket (429 + a
    ``tenant.noisy.throttled`` row) while the quiet tenant's next
    request is admitted untouched.

    **Autoscaler kill**: an :class:`Autoscaler` over a REAL router
    scales 1 -> 2 through the warmed-admission seam, then the
    ``control.autoscaler`` fault kills the loop mid-run.  The pool must
    freeze at its current size, further pressure windows must take no
    action, and routing must keep serving with greedy parity.
    """
    from .. import observability
    from ..control import (Autoscaler, AutoscalerConfig, BrownoutConfig,
                           BrownoutController, ControlSignals, OverloadGate,
                           Throttled, TokenBucketAdmission)
    from ..control.autoscaler import router_actuators
    from ..control.overload import BucketConfig
    from ..device import resolve_device
    from ..models import zoo
    from ..observability import METRICS
    from ..resilience import FaultSpec, inject_faults
    from ..serving import (EngineReplica, InferenceEngine, PrefixRouter,
                           RouterConfig, ServingConfig)

    dev = resolve_device(device)
    rng = random.Random(seed + 3)
    observability.enable()
    METRICS.reset()

    cfg, model, params = _chaos_lm(cfg, dev, max_len=32)
    draft, dparams = zoo.draft_lm(cfg, seed=99, device=dev)
    engine = InferenceEngine(
        model, params=params,
        cfg=ServingConfig(slots=3, resolve_every=2, speculative=True,
                          spec_k=2),
        draft_model=draft, draft_params=dparams, device=dev).start()

    clamp = 4
    clock = [1000.0]
    brownout = BrownoutController(
        engine, BrownoutConfig(enter_burn=(1.0, 2.0, 4.0), exit_fraction=0.5,
                               dwell_s=5.0, clamp_max_new=clamp),
        clock=lambda: clock[0])
    OverloadGate(bucket=TokenBucketAdmission(clock=lambda: clock[0]),
                 brownout=brownout).install(engine)

    def serve(n: int, priority: int = 0, tenant: str = "quiet"):
        """Submit n greedy requests; returns (plans, outputs, rejects)."""
        plans = [dict(prompt=[rng.randrange(cfg.vocab_size)
                              for _ in range(rng.randint(1, 8))],
                      max_new_tokens=rng.randint(2, 8), temperature=0.0,
                      seed=rng.randrange(1 << 16))
                 for _ in range(n)]
        handles, rejects = [], 0
        for p in plans:
            try:
                handles.append((p, engine.submit(**p, tenant=tenant,
                                                 priority=priority)))
            except Throttled:
                rejects += 1
        outs = [(p, h.result(60.0)) for p, h in handles]
        return plans, outs, rejects

    def parity(outs, effective_cap=None) -> list[str]:
        bad = []
        for p, out in outs:
            n = p["max_new_tokens"] if effective_cap is None \
                else min(p["max_new_tokens"], effective_cap)
            exp = model.sample(params, p["prompt"], n, temperature=0.0,
                               seed=p["seed"], kv_cache=True)[len(p["prompt"]):]
            if out.tokens != exp:
                bad.append(f"{p}: {out.tokens} != {exp}")
        return bad

    # ---- phase 1: walk the ladder up, serving with parity at every level
    ladder: list[dict] = []
    parity_failures: list[str] = []
    for burn, want_level in [(0.0, 0), (1.2, 1), (2.5, 2), (5.0, 3)]:
        clock[0] += brownout.cfg.dwell_s + 1.0   # clears dwell AND refills
        level = brownout.update(burn)
        assert level == want_level, (
            f"seed {seed}: burn {burn} drove level {level}, "
            f"wanted {want_level}")
        stats = engine.stats()
        assert stats["speculative_enabled"] == (level < 1), (level, stats)
        assert stats["max_new_cap"] == (clamp if level >= 2 else None), \
            (level, stats)
        _, outs, _ = serve(3)
        parity_failures += parity(
            outs, effective_cap=clamp if level >= 2 else None)
        shed_rejects = 0
        if level >= 3:
            _, bg_outs, shed_rejects = serve(3, priority=1, tenant="batch")
            assert shed_rejects == 3 and not bg_outs, (
                f"seed {seed}: level 3 served background work "
                f"({shed_rejects}/3 shed)")
        ladder.append({"burn": burn, "level": level, "served": len(outs),
                       "background_shed": shed_rejects})

    # ---- descend one rung at a time; full quality restored at the bottom
    for want_level in (2, 1, 0):
        clock[0] += brownout.cfg.dwell_s + 1.0
        level = brownout.update(0.1)
        assert level == want_level, (
            f"seed {seed}: descent reached {level}, wanted {want_level} "
            "(must step one rung at a time)")
    assert engine.stats()["speculative_enabled"] is True
    clock[0] += brownout.cfg.dwell_s + 1.0
    _, outs, _ = serve(3)
    parity_failures += parity(outs)

    # ---- phase 2: tight fair-share bucket — noisy tenant starves itself
    OverloadGate(bucket=TokenBucketAdmission(
        BucketConfig(rate_tokens_s=0.0, burst_tokens=20.0),
        clock=lambda: clock[0]), brownout=brownout).install(engine)
    noisy_plans = [dict(prompt=[1, 2, 3], max_new_tokens=8, temperature=0.0,
                        seed=rng.randrange(1 << 16)) for _ in range(5)]
    noisy_served, noisy_throttled = [], 0
    for p in noisy_plans:
        try:
            noisy_served.append((p, engine.submit(**p, tenant="noisy")))
        except Throttled:
            noisy_throttled += 1
    quiet_plan = dict(prompt=[4, 5, 6], max_new_tokens=8, temperature=0.0,
                      seed=rng.randrange(1 << 16))
    quiet_handle = engine.submit(**quiet_plan, tenant="quiet")
    parity_failures += parity([(p, h.result(60.0)) for p, h in noisy_served])
    parity_failures += parity([(quiet_plan, quiet_handle.result(60.0))])
    counters = METRICS.snapshot()["counters"]
    assert noisy_throttled == 3 and len(noisy_served) == 2, (
        f"seed {seed}: 20-token bucket admitted {len(noisy_served)}/5 "
        f"8-token requests ({noisy_throttled} throttled)")
    assert counters.get("tenant.noisy.throttled", 0) >= 3, counters
    assert "tenant.quiet.throttled" not in counters, (
        "quiet tenant was throttled for the noisy tenant's burst")
    engine.set_admission_hook(None)
    engine.stop()

    # ---- phase 3: chaos-kill the autoscaler mid-run over a real router
    def replica(name: str) -> EngineReplica:
        eng = InferenceEngine(model, params=params,
                              cfg=ServingConfig(slots=2, resolve_every=2),
                              device=dev).start()
        return EngineReplica(name, eng, own_engine=True)

    serial = [0]

    def factory() -> EngineReplica:
        serial[0] += 1
        return replica(f"k{serial[0]}")

    router = PrefixRouter([replica("k0")], RouterConfig(
        page_size=4, probe_interval_s=0.5))
    acfg = AutoscalerConfig(min_replicas=1, max_replicas=4, cooldown_s=10.0)
    up, down, size = router_actuators(router, factory, acfg)
    sim_t, feed = [0.0], []
    scaler = Autoscaler(lambda: feed.pop(0), up, down, size, acfg,
                        clock=lambda: sim_t[0])

    def play(sig):
        sim_t[0] += acfg.cooldown_s + 1.0
        feed.append(sig)
        return scaler.step()

    pressure = ControlSignals(burn=3.0, queue_depth=64)
    took = play(pressure)
    assert took == "up" and len(router.pool.names()) == 2, (
        took, router.pool.names())
    with inject_faults(FaultSpec("control.autoscaler", probability=1.0),
                       seed=seed):
        killed_take = play(pressure)
    frozen = len(router.pool.names())
    post_kill = [play(pressure) for _ in range(3)]
    probe = dict(prompt=[3, 1, 4], max_new_tokens=6, temperature=0.0, seed=0)
    routed = [router.generate(**probe) for _ in range(4)]
    exp = model.sample(params, probe["prompt"], probe["max_new_tokens"],
                       temperature=0.0, seed=0,
                       kv_cache=True)[len(probe["prompt"]):]
    snap = METRICS.snapshot()
    router.close()   # pool.close() closes every replica's engine

    result = {
        "seed": seed,
        "ladder": ladder,
        "parity_failures": parity_failures[:5],
        "brownout_transitions":
            int(snap["counters"].get("control.brownout_transitions", 0)),
        "noisy_throttled": noisy_throttled,
        "shed": int(snap["counters"].get("control.shed", 0)),
        "autoscaler_killed":
            int(snap["counters"].get("control.autoscaler_killed", 0)),
        "pool_after_kill": frozen,
        "actions_after_kill": [a for a in post_kill if a],
        "routed_after_kill": len(routed),
    }
    assert not parity_failures, (
        f"seed {seed}: brownout broke token parity: {parity_failures[:3]}")
    # 3 up + 3 down rungs walked exactly once each
    assert result["brownout_transitions"] == 6, result
    assert scaler.dead and killed_take is None, (killed_take, result)
    assert frozen == 2 and not result["actions_after_kill"], (
        f"seed {seed}: killed autoscaler kept acting: {result}")
    assert snap["gauges"].get("control.autoscaler_alive") == 0.0, (
        "autoscaler death is invisible on the alive gauge")
    assert all(r["tokens"] == exp for r in routed), (
        f"seed {seed}: routing broke after the autoscaler died: "
        f"{[r['tokens'] for r in routed]} != {exp}")
    assert scaler.start() is False, "a dead autoscaler must not restart"
    return result


def main(argv: list[str]) -> int:
    from ..device import resolve_device
    from .ranks import RankPool

    def arg(flag, default, cast=int):
        return cast(argv[argv.index(flag) + 1]) if flag in argv else default

    device = resolve_device(arg("--platform", "cuda", str))
    seed = arg("--seed", None)
    world = arg("--world", 8)
    shardguard = None
    if "--shardguard" in argv:
        # run every leg with runtime sharding-drift detection: injected
        # faults drive recovery paths (mesh shrink/grow, reload) that are
        # exactly where a step can start dispatching onto stale placements
        from ..analysis.shardguard import SHARDGUARD as shardguard
        shardguard.reset()
        shardguard.enable()
        close_ranks()
        _POOL[0] = RankPool(world, str(device), shardguard=True)
    try:
        return _dispatch_legs(argv, seed, shardguard, device, world)
    finally:
        if shardguard is not None:
            shardguard.disable()
        close_ranks()


def _dispatch_legs(argv: list[str], seed, shardguard, device,
                   world: int) -> int:
    def finish(result: dict) -> int:
        if shardguard is not None:
            local = len(shardguard.violations())
            ranks = _POOL[0].shardguard_violations() if _POOL[0] else 0
            result["shardguard_violations"] = local + ranks
            assert not local, shardguard.report()
            assert not ranks, f"{ranks} shardguard violations on the ranks"
        print(json.dumps(result))
        return 0

    def drawn():
        return seed if seed is not None \
            else random.SystemRandom().randrange(2 ** 31)

    if "--elastic" in argv:
        # replay a single failing elastic draw
        return finish(run_elastic(drawn(), world=world, device=device))
    if "--online" in argv:
        # replay a single failing online-loop draw
        return finish(run_online(drawn(), device=device))
    if "--overload" in argv:
        # replay a single failing overload/brownout draw
        return finish(run_overload(drawn(), device=device))
    if "--disagg" in argv:
        # replay a single failing disagg-migration draw
        return finish(run_disagg(drawn(), device=device))
    if "--stage" in argv:
        # replay a single failing (seed, stage) draw
        stage = int(argv[argv.index("--stage") + 1])
        return finish(run(seed, zero_stage=stage, world=world,
                          device=device))
    # one random plan per ZeRO stage: recovery must restore BITWISE params
    # whether optimizer state (and, at stage 3, params) live sharded or
    # replicated — a corrupted/per-shard-mismatched restore would show up
    # as parity failure here
    result = run(seed, world=world, device=device)
    base = result["seed"]
    result["zero_stages"] = {
        stage: run(base + stage, zero_stage=stage, world=world,
                   device=device) for stage in (1, 2, 3)}
    result["serving"] = run_serving(base, device=device)
    result["serving_kv_int8"] = run_serving(base, kv_quant="int8",
                                            device=device)
    result["disagg"] = run_disagg(base, device=device)
    result["elastic"] = run_elastic(base, world=world, device=device)
    result["online"] = run_online(base, device=device)
    result["overload"] = run_overload(base, device=device)
    return finish(result)


if __name__ == "__main__":
    import warnings

    warnings.simplefilter("ignore", UserWarning)   # checkpoint-fallback noise
    sys.exit(main(sys.argv[1:]))
