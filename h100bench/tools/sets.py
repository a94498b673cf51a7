"""Run one cell several times in turn and keep each run's result line.

    python3 h100bench/tools/sets.py --workload W --seeds 1,2,3 \\
        --seconds 30 [--trace 0] --out out/W.set1.jsonl

Each run is its own process, as the benchmark's own check runs it, from
the root of the checkout; its standard error goes beside ``--out``
(``.<seed>.err``).  A run that exits non-zero or prints no result is
recorded as ``{"seed": n, "rc": code}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for seed in args.seeds.split(","):
            err = out.with_name(f"{out.stem}.{seed}.err")
            t = time.perf_counter()
            with err.open("w") as e:
                p = subprocess.run(
                    [sys.executable, "h100bench/run.py", "--workload",
                     args.workload, "--seed", seed, "--seconds",
                     args.seconds, "--trace", args.trace],
                    cwd=ROOT, stdout=subprocess.PIPE, stderr=e, text=True)
            wall = time.perf_counter() - t
            lines = [x for x in p.stdout.splitlines() if x.startswith("{")]
            row = (json.loads(lines[-1]) if p.returncode == 0 and lines
                   else {"rc": p.returncode})
            row.update(seed=int(seed), wall_s=wall)
            f.write(json.dumps(row) + "\n")
            f.flush()
            m = {k: v["value"] for k, v in row.get("metrics", {}).items()}
            print(json.dumps({"seed": seed, "rc": p.returncode,
                              "correct": row.get("correct"), "wall_s": wall,
                              "metrics": m,
                              "compared": row.get("compared")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
