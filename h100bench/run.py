"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``deeplearning4j_tpu_torch``
(the program) and ``BENCHMARK.json``.  ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` runs the same cell with a traced
sub-window and reports its per-layer metrics, the device's busy time and
a breakdown.  The last line of standard output is one JSON object; the
numbers compared with the plain reference, each beside its limit, come
last in it and as the last lines of standard error.

``--candidates`` also finds the cells of ``h100bench/candidates.json``,
which are proven but kept out of ``BENCHMARK.json``; the benchmark's own
runs never pass it.

Exits non-zero and prints no result when the card or the program is
missing, or when a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

_T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the run may not load: the JAX stack and the
#: JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")
#: build and kernel caches, at fixed paths inside the checkout
CACHE = ROOT / ".h100bench_cache"


def process_age_s() -> float:
    """Seconds since this process started (its start, not this module's
    import, where /proc has it)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_START


def set_caches() -> None:
    """Point every build and kernel cache of the program into the
    checkout, so that only the first run of a cell there builds."""
    for var, sub in (("DL4J_TORCH_BUILD_DIR", "dl4j_build"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def finite_or_none(x):
    """A reading for JSON: non-finite numbers become null."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def merge(base: dict, extra: dict) -> dict:
    """``base`` with ``extra`` laid over it, dict by dict."""
    out = dict(base)
    for k, v in extra.items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def fail(msg: str, code: int) -> None:
    print(f"h100bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_line() -> tuple[str, str]:
    """(name, power limit) from nvidia-smi; empty strings where it fails."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        name, limit = out.stdout.strip().splitlines()[0].split(",", 1)
        return name.strip(), limit.strip()
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return "", ""


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: dict | None = None,
             setup_hook=None, candidates: bool = False) -> dict:
    """One run of ``workload``; returns the result (its ``metrics`` are
    the end-to-end ones, or with ``trace`` the per-layer ones).

    ``device``, ``overrides`` (``{"config": {...}, "traffic": {...},
    "limits": {...}}`` merged over the files) and ``setup_hook(ctx)``
    (called before set-up) serve the CPU tests, which rehearse a run at a
    small size and plant faults in it; ``candidates`` also finds the cells
    of ``candidates.json``."""
    from h100bench.core import manifest, peaks
    from h100bench.core.context import RunContext
    from h100bench.core.model import model_of
    from h100bench.core.trace import OpRanges

    cell = manifest.load_cell(workload, ROOT, candidates)
    for key, extra in (overrides or {}).items():
        setattr(cell, key, merge(getattr(cell, key), extra))
    on_card = device.startswith("cuda")
    if on_card:
        import torch

        card = peaks.for_card(torch.cuda.get_device_name(0))
        torch.cuda.reset_peak_memory_stats()
    else:
        card = peaks.REHEARSAL
    ctx = RunContext(cell=cell, model=model_of(cell.config),
                     settings=cell.settings(), device=device, peaks=card,
                     seed=seed, seconds=seconds, trace=trace)
    mods = {}
    if trace:
        ctx.ranges = OpRanges()
        for m in cell.per_layer:
            mods[m["name"]] = manifest.load_metric(m["name"])
            install = getattr(mods[m["name"]], "install", None)
            if install is not None:
                install(ctx)
    if setup_hook is not None:
        setup_hook(ctx)
    if cell.kind == "train":
        from h100bench.core import train as driver
    elif cell.kind == "serve":
        from h100bench.core import serve as driver
    else:
        raise SystemExit(f"h100bench: no driver for traffic kind "
                         f"{cell.kind!r}")
    out = driver.run(ctx, process_age_s)

    compared, correct = {}, out["ok"]
    numbers = cell.limits.get("numbers", {})
    for name, value in out["readings"].items():
        limit = numbers.get(name, {}).get("limit")
        compared[name] = {"value": finite_or_none(value), "limit": limit}
        if limit is None or not (value <= limit):
            correct = False
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = mods[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in values.items() if k in units}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": None, "count": 1,
                         "memory_peak_bytes": ctx.memory_peak_bytes}}
    if on_card:
        import torch

        result["device"]["kind"] = torch.cuda.get_device_name(0)
        result["device"]["power_limit"] = card_line()[1]
    if trace and ctx.traced is not None:
        result["device"]["busy_s"] = ctx.traced.busy_s
        result["device"]["window_s"] = ctx.traced.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in ctx.traced.device_ops],
            "idle_gaps": [[n, s] for n, s in ctx.traced.idle_gaps]}
    result["notes"] = out.get("notes", {})
    if trace and ctx.traced is not None:
        result["notes"]["ranges"] = {
            op: [n, len(ctx.ranges.calls.get(op, [])),
                 ctx.traced.op_device_s.get(op, 0.0)]
            for op, n in ctx.traced.op_range_count.items()}
    result["compared"] = compared
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--candidates", action="store_true",
                    help="also find the cells of h100bench/candidates.json")
    args = ap.parse_args()

    set_caches()
    sys.path.insert(0, str(ROOT))
    from h100bench.core import manifest

    if not (ROOT / "deeplearning4j_tpu_torch").is_dir():
        fail(f"no program (deeplearning4j_tpu_torch) in {ROOT}", 3)
    chips = None
    for w in manifest.lookup(ROOT, args.candidates)["workloads"]:
        if w["name"] == args.workload:
            chips = w["chips"]
    if chips is None:
        fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the benchmark needs the "
             "card", 2)
    if torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
             "found", 2)
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program does not import: {e}", 3)

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), candidates=args.candidates)
    found = forbidden_modules()
    if found:
        fail(f"JAX modules were loaded: {found}", 4)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
