"""A run of a cell on the CPU at a small size: the harness's whole path
(set-up, window, trace, the reference and the comparison) with the
program's plain versions in place of its kernels.  No number of such a
run is a device number.

    python3 h100bench/tools/rehearse.py --workload W [--seconds 3] [--trace 1]

The small sizes keep every width ratio of the cell's configuration and
the shapes its kernels route on (sequences of whole 128-token blocks);
``LIMITS`` are the limits at these sizes, set from sound CPU runs and
the CPU control (``test_h100bench_faults.py``), not the cells' own.  The
rehearsal also finds the cells of ``candidates.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL = {
    "bert-base.train-64x512": {
        "config": {"vocab_size": 512, "hidden_size": 64,
                   "num_attention_heads": 4, "num_hidden_layers": 2,
                   "intermediate_size": 256, "max_position_embeddings": 128},
        "traffic": {"batch": 4, "seq": 128, "batches": 5,
                    "reference_rows": 2, "idle_steps": 2, "trace_steps": 1}},
    "gpt2-small.train-64x1024": {
        "config": {"vocab_size": 512, "n_embd": 64, "n_head": 4,
                   "n_layer": 2, "n_positions": 256, "n_ctx": 256},
        "traffic": {"batch": 4, "seq": 256, "batches": 5,
                    "token_id_high": 500, "reference_rows": 2,
                    "idle_steps": 2, "trace_steps": 1}},
    "gpt2-small.serve-int8-decode32": {
        "config": {"vocab_size": 512, "n_embd": 64, "n_head": 4,
                   "n_layer": 2, "n_positions": 256, "n_ctx": 256,
                   "serve": {"engine": {"slots": 4}}},
        "traffic": {"clients": 4, "prompt_tokens": [4, 12],
                    "output_tokens": [16, 48], "ramp_output_tokens": [1, 48],
                    "token_id_high": 500, "requests_per_client": 40,
                    "check_requests": 3, "drain_s": 60, "trace_s": 1.0}},
}

#: the limits at the small sizes (PERF.md gives the readings)
LIMITS = {
    "bert-base.train-64x512": {"loss": 4e-5, "grad": 0.008, "change": 0.007},
    "gpt2-small.train-64x1024": {"loss": 4e-5, "grad": 0.008, "change": 0.007},
    "gpt2-small.serve-int8-decode32": {"token_gap": 0.05},
}


def overrides(workload: str) -> dict:
    small = SMALL[workload]
    return dict(small, limits={"numbers": {
        k: {"limit": v} for k, v in LIMITS[workload].items()}})


def rehearse(workload: str, seed: int, seconds: float, trace: bool,
             setup_hook=None) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "h100bench"))
    import run as runner

    runner.set_caches()
    return runner.run_cell(workload, seed, seconds, trace, device="cpu",
                           overrides=overrides(workload),
                           setup_hook=setup_hook, candidates=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, choices=sorted(SMALL))
    ap.add_argument("--seed", type=int, default=2 ** 31 + 1)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args()
    res = rehearse(args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(res, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
