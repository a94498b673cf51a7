"""Readings to set a cell's limits from: the program on many seeds, the
control (the plain reference one step of precision lower, in the
program's place) and the planted faults, at the cell's own size, all in
one process.

    python3 h100bench/tools/limits.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 5] [--candidates] \\
        --report out/readings.json

Training: each seed's program record of the set-up's first steps (no
window is needed), against the float32 reference's; on the control
seeds also the fp8 reference and the reference that leaves out half of
each batch, each against the float32 reference.  A step that returns its
state unchanged reads 1 by the comparison's measure and needs no run.

Serving: each seed runs the cell for a short window at its own load and
drains; its checked sample's widest gap, and on the control seeds the
gap of the token the int4 reference puts first at each of the same
positions, and the widest gap with one served token of each checked
request altered (to the next id).

Prints one JSON line per seed and writes them all to ``--report``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def train_seed(ctx, seed: int, control: bool) -> dict:
    import torch

    from h100bench.core import train
    from h100bench.reference import compare

    t = time.perf_counter()
    st = train.build(ctx, seed)
    prog = train.check_steps(ctx, st, seed)
    batches = st["batches"]
    st.clear()
    torch.cuda.empty_cache()
    ref = train.reference_record(ctx, seed, batches)
    out = {"seed": seed, "program": compare.train_readings(prog, ref),
           "losses": {"program": prog["losses"], "reference": ref["losses"]}}
    if control:
        for name, kw in (("control_fp8", {"quant": "fp8"}),
                         ("fault_half_batch", {"half_batch": True})):
            rec = train.reference_record(ctx, seed, batches, **kw)
            out[name] = compare.train_readings(rec, ref)
        still = dict(prog, grad_norms={k: 0.0 for k in ref["grad_norms"]},
                     change_norms={k: 0.0 for k in ref["change_norms"]})
        out["fault_unchanged"] = compare.train_readings(still, ref)
    out["seconds"] = time.perf_counter() - t
    return out


def serve_seed(ctx, seed: int, control: bool) -> dict:
    import torch

    from h100bench.core import serve, traffic, weights
    from h100bench.reference import compare

    t = time.perf_counter()
    engine = serve.build_engine(ctx, seed)
    engine.start()
    try:
        w = serve.serve_window(ctx, engine, traffic.serve_plan(
            ctx.cell.traffic, seed))
    finally:
        engine.stop()
    w["loop"].join(30.0)
    acc = serve.account(ctx, w)
    del engine
    torch.cuda.empty_cache()
    picked = serve.sample(ctx, w["loop"], seed)
    out = {"seed": seed, "attempted": acc["attempted"],
           "failed": acc["failed"], "drained": w["drained"],
           "checked_tokens": sum(len(c.tokens) for _, c in picked),
           "program": {"token_gap": serve.check(ctx, seed, picked)}}
    if control:
        out["control_int4"] = {"token_gap": serve.check(ctx, seed, picked,
                                                        quant="int4")}
        params = weights.make(ctx.model, seed, ctx.device)
        gaps = []
        for req, comp in picked:
            served = list(comp.tokens)
            j = len(served) // 2
            served[j] = (served[j] + 1) % ctx.model["vocab_size"]
            gaps += compare.served_gaps(params, ctx.model, req.prompt,
                                        served, ctx.device)
        out["fault_altered_token"] = {"token_gap": max(gaps)}
    out["seconds"] = time.perf_counter() - t
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--report", required=True)
    ap.add_argument("--candidates", action="store_true",
                    help="also find the cells of h100bench/candidates.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "h100bench"))
    import run as runner

    runner.set_caches()
    import torch

    from h100bench.core import manifest, peaks
    from h100bench.core.context import RunContext
    from h100bench.core.model import model_of

    if not torch.cuda.is_available():
        runner.fail("the readings are taken on the card", 2)
    cell = manifest.load_cell(args.workload, candidates=args.candidates)
    ctx = RunContext(cell=cell, model=model_of(cell.config),
                     settings=cell.settings(), device="cuda",
                     peaks=peaks.for_card(torch.cuda.get_device_name(0)),
                     seed=0, seconds=args.seconds, trace=False)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    fn = train_seed if cell.kind == "train" else serve_seed
    rows = []
    for seed in seeds:
        ctx.seed = seed
        row = fn(ctx, seed, seed in controls)
        row["card"] = runner.card_line()
        rows.append(row)
        print(json.dumps(row), flush=True)
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
