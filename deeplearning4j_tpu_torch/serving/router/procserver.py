"""Child-process entry point for :class:`~.replicas.ProcessReplica`.

Port of ``deeplearning4j_tpu/serving/router/procserver.py``.

``python -m deeplearning4j_tpu_torch.serving.router.procserver --factory
pkg.module:callable --factory-json '{...}' --port-file P --stop-file S``
builds an engine from the factory spec, mounts it on a real
:class:`~..server.ModelServer` on a free port, writes the bound port
atomically to ``--port-file`` (the parent's boot barrier: the interpreter,
torch and the CUDA context take seconds), then parks until
``--stop-file`` appears or SIGTERM lands.  ``--trace-out`` streams every
completed span to a JSONL event log, so a multi-process run's traces
merge into one cross-process critical path.

:func:`tiny_lm_factory` builds the same fixed-seed model in parent and
child, so tests compare routed tokens with the offline sampler's.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from pathlib import Path


def tiny_lm_factory(seed: int = 7, vocab_size: int = 64, d_model: int = 32,
                    n_heads: int = 4, n_layers: int = 2, d_ff: int = 64,
                    max_len: int = 64, slots: int = 4, resolve_every: int = 4,
                    max_queue: int = 64, paged: bool = False,
                    page_size: int = 16, prefix_cache: bool = False,
                    role: str = "unified", device: str = "cuda"):
    """The test-battery engine: a fixed-seed tiny f32 transformer,
    identical for identical kwargs in any process.  The parameters are
    drawn from ``seed`` on a CPU ``torch.Generator`` and then placed on
    ``device``, so every process builds the same weights.
    ``role="prefill"`` builds a prefill-tier worker (paged forced on, the
    migration unit being a KV page; no serve thread, so a router's probe
    refuses it as a decode target)."""
    import torch

    from ...models.transformer import TransformerConfig, TransformerLM
    from ..engine import InferenceEngine, ServingConfig

    cfg = TransformerConfig(vocab_size=vocab_size, d_model=d_model,
                            n_heads=n_heads, n_layers=n_layers, d_ff=d_ff,
                            max_len=max_len, dtype=torch.float32, remat=False,
                            xent_chunk=0)
    model = TransformerLM(cfg, device=device)
    params = model.init(torch.Generator().manual_seed(seed))
    if role == "prefill":
        paged = True
    return InferenceEngine(
        model, params=params,
        cfg=ServingConfig(slots=slots, resolve_every=resolve_every,
                          max_queue=max_queue, paged=paged,
                          page_size=page_size, prefix_cache=prefix_cache,
                          role=role),
        device=device)


def _resolve(spec: str):
    """``"pkg.module:attr"`` -> callable."""
    import importlib

    mod, _, attr = spec.partition(":")
    return getattr(importlib.import_module(mod), attr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--name", required=True)
    ap.add_argument("--port-file", required=True)
    ap.add_argument("--stop-file", required=True)
    ap.add_argument("--factory", required=True,
                    help='engine factory as "module:callable"')
    ap.add_argument("--factory-json", default="{}",
                    help="JSON kwargs for the factory")
    ap.add_argument("--trace-out", default=None,
                    help="stream completed spans to this JSONL file")
    args = ap.parse_args(argv)

    from ... import observability
    from ...observability import TRACER
    from ..server import ModelServer

    observability.enable()
    if args.trace_out:
        TRACER.stream_jsonl(args.trace_out)

    engine = _resolve(args.factory)(**json.loads(args.factory_json))
    engine.start()
    server = ModelServer(engine=engine)
    server.start()

    # atomic publish: the parent must never read a half-written port
    port_file = Path(args.port_file)
    tmp = port_file.with_suffix(".tmp")
    tmp.write_text(str(server.port))
    os.replace(tmp, port_file)

    stop_file = Path(args.stop_file)
    stopping = {"now": False}

    def _sigterm(_sig, _frm):
        stopping["now"] = True

    signal.signal(signal.SIGTERM, _sigterm)
    while not stopping["now"] and not stop_file.exists():
        time.sleep(0.1)

    server.stop()
    engine.stop()
    TRACER.stop_stream()
    return 0


if __name__ == "__main__":
    sys.exit(main())
