#!/usr/bin/env python3
"""The transfer guard's two mechanisms, timed on one NVIDIA GPU.

    python3 guard_probe.py [--report PATH]

``deeplearning4j_tpu_torch.analysis.runtime.hot_loop_guard`` sees a host
sync on a GPU through PyTorch's sync check (``set_sync_debug_mode`` held
at "warn", the warning refused on the guarded thread).  The other way to
see it is a ``TorchDispatchMode`` over the same operations, one Python
call per ATen op, the mechanism the guard's CPU seam uses.  This probe
runs ``chip_smoke.py``'s phase-15j cost pairs (``guard_costs``) at the
flagship's width with the guard off, on (the sync check) and on through
the dispatch mode, in the order off, on, dispatch, on, off, off, on:
engine A's decode-step p50 (8 prompts of 8 tokens, 32 new) and
``fit``'s step p50 at 15i's Driver config (16 x 512, 5 steps), the
tokens and losses equal in every mode, and the guard's own enter and
exit.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MODES = ("off", "on", "dispatch", "on", "off", "off", "on")


def fail(msg: str) -> None:
    print(f"guard_probe: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", help="also write the results (JSON) here")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this probe needs a GPU")
    if not (ROOT / "deeplearning4j_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no deeplearning4j_tpu_torch checkout")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.analysis import runtime as rt
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.ops.cuda import build
    from deeplearning4j_tpu_torch.serving import engine as eng

    sync_check = rt._mechanisms

    def dispatch_mode():
        """The guard's mechanisms with the CUDA device watched by the
        dispatch mode instead of the sync check."""
        debug, watched = sync_check()
        return False, watched | ({"cuda"} if debug else set())

    @contextlib.contextmanager
    def guard_as(rt_, mode):
        with cs.transfer_guard_as(rt_, "off" if mode == "off" else "on"):
            if mode == "dispatch":
                rt_._mechanisms = dispatch_mode
            try:
                yield
            finally:
                rt_._mechanisms = sync_check

    build.build_all()
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    mcfg = ttr.TransformerConfig()
    tmodel = ttr.TransformerLM(mcfg, device="cuda")
    params = tmodel.init(torch.Generator(device="cuda").manual_seed(0))
    scfg = eng.ServingConfig(slots=8, paged=True, page_size=16,
                             int8_decode=True, paged_attention_impl="pallas")
    rep, _ = cs.guard_costs(torch, eng, tmodel, params, scfg,
                            np.random.default_rng(17), "cuda", modes=MODES,
                            guard_as=guard_as)
    rep = {"card": card, "modes": list(MODES), **rep}
    print(json.dumps(rep), flush=True)
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
