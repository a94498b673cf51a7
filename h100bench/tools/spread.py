"""Spreads of repeated runs, and the bounds they give.

    python3 h100bench/tools/spread.py SET1.jsonl [SET2.jsonl ...]

Each file holds the result lines of one set of runs of one cell (as
``tools/sets.py`` writes them).  Per metric: each set's median and its
spread, the distance between the first and third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median; the
bound of about five times the widest spread (never under 1%); the spread
with each set's run farthest from its median left out; and how far the
second set's median lies from the first's.
"""

from __future__ import annotations

import json
import statistics
import sys


def iqr_share(values: list) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def without_farthest(values: list) -> list:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def load(path: str) -> list:
    rows = []
    for line in open(path):
        line = line.strip()
        if line.startswith("{"):
            rows.append(json.loads(line))
    return rows


def report(sets: list) -> dict:
    names = sorted({m for rows in sets for r in rows for m in r["metrics"]})
    out = {}
    for name in names:
        per = [[r["metrics"][name]["value"] for r in rows
                if name in r["metrics"]] for rows in sets]
        per = [v for v in per if len(v) >= 2]
        if not per:
            continue
        spreads = [iqr_share(v) for v in per]
        trimmed = [iqr_share(without_farthest(v)) for v in per if len(v) >= 3]
        meds = [statistics.median(v) for v in per]
        out[name] = {
            "medians": meds, "spreads": spreads,
            "widest": max(spreads),
            "bound_5x": max(0.01, 5 * max(spreads)),
            "trimmed_mean_spread": (statistics.mean(trimmed) if trimmed
                                    else None),
            "second_vs_first": (meds[1] / meds[0] - 1 if len(meds) > 1
                                else None),
            "n": [len(v) for v in per]}
    return out


def main() -> int:
    sets = [load(p) for p in sys.argv[1:]]
    for row in sets:
        bad = [r for r in row if not r.get("correct")]
        if bad:
            print(f"{len(bad)} run(s) not correct", file=sys.stderr)
    print(json.dumps(report(sets), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
