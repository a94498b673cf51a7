"""Executable runner: ``python -m deeplearning4j_tpu_torch <command> ...``.

Port of ``deeplearning4j_tpu/__main__.py``:

- ``train``    — build a MultiLayerNetwork from a JSON conf (``-json`` /
                 ``-jsonpath``) or a zoo preset, fit on a named dataset,
                 print the evaluation, optionally save the model.
- ``evaluate`` — load a saved model (either package's file), evaluate on a
                 named dataset.
- ``dryrun``   — the multi-rank sharding dryrun: ``--devices N`` gloo
                 ranks spawned on the CPU or all on one card, one SPMD
                 train step each over a dp/pp/tp(/sp) mesh, ZeRO-1 and
                 the ring; prints the reference's ``dryrun_multichip OK``
                 line.
- ``scaleout``, ``provision`` parse as in the reference and exit naming
  their ``ROADMAP.md`` item, A10.3 (the host control plane).

``--platform`` (before the command or after it) is the torch device and
defaults to ``cuda``: without a card the run raises, it never falls back
to the CPU.  ``--platform cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _dataset(name: str, batch: int):
    from .datasets import (DigitsDataSetIterator, IrisDataSetIterator,
                           MnistDataSetIterator)
    name = name.lower()
    if name == "iris":
        it = IrisDataSetIterator(batch=batch)
    elif name == "digits":
        it = DigitsDataSetIterator(batch=batch)
    elif name == "mnist":
        it = MnistDataSetIterator(batch=batch)
    else:
        raise SystemExit(f"unknown dataset {name!r} (iris|digits|mnist)")
    ds = it.next()
    return ds.normalize_zero_mean_unit_variance().shuffle(seed=42)


def _cmd_train(args) -> int:
    from .nn import MultiLayerNetwork
    from .nn.conf import MultiLayerConfiguration

    if args.json:
        conf = MultiLayerConfiguration.from_json(args.json)
    elif args.jsonpath:
        conf = MultiLayerConfiguration.from_json(Path(args.jsonpath).read_text())
    else:
        from .models import zoo
        builders = {"mlp": lambda n_in, n_out: zoo.mlp(
                        n_in, n_out, num_iterations=args.iterations,
                        device=args.device),
                    "dbn": lambda n_in, n_out: zoo.dbn(
                        n_in, n_out, finetune_iterations=args.iterations,
                        device=args.device)}
        if args.model not in builders:
            raise SystemExit(f"unknown --model {args.model!r} (mlp|dbn) "
                             "— or pass -json/-jsonpath")
        ds = _dataset(args.dataset, args.batch)
        net = builders[args.model](ds.features.shape[-1], ds.labels.shape[-1])
        conf = None

    if conf is not None:
        ds = _dataset(args.dataset, args.batch)
        net = MultiLayerNetwork(conf, device=args.device)
    net.init(args.seed)
    net.fit(ds)
    ev = net.evaluate(ds)
    print(ev.stats())
    if args.out:
        net.save(args.out)
        print(f"model saved to {args.out}")
    return 0


def _cmd_evaluate(args) -> int:
    from .nn import MultiLayerNetwork
    net = MultiLayerNetwork.load(args.model_path, device=args.device)
    ds = _dataset(args.dataset, args.batch)
    print(net.evaluate(ds).stats())
    return 0


def _cmd_dryrun(args) -> int:
    from .parallel.dryrun import run_dryrun
    try:
        run_dryrun(args.devices, device=str(args.device))
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


def _not_ported(args) -> int:
    raise SystemExit(
        f"python -m deeplearning4j_tpu_torch {args.command}: the host "
        "control plane (scaleout, provisioning) is not ported yet "
        "(ROADMAP.md A10.3); use the JAX package's CLI")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deeplearning4j_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    platform_help = ("torch device (default cuda, which raises without a "
                     "card; pass 'cpu' to run on the CPU)")

    t = sub.add_parser("train", help="fit a network on a named dataset")
    t.add_argument("--model", default="mlp", help="zoo preset (mlp|dbn)")
    t.add_argument("-json", dest="json", help="MultiLayerConfiguration JSON")
    t.add_argument("-jsonpath", dest="jsonpath", help="path to conf JSON")
    t.add_argument("--dataset", default="iris")
    t.add_argument("--batch", type=int, default=512)
    t.add_argument("--iterations", type=int, default=150)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--out", help="save trained model here")
    t.add_argument("--platform", default=argparse.SUPPRESS,
                   help=platform_help)
    t.set_defaults(fn=_cmd_train)

    e = sub.add_parser("evaluate", help="evaluate a saved model")
    e.add_argument("model_path")
    e.add_argument("--dataset", default="iris")
    e.add_argument("--batch", type=int, default=512)
    e.add_argument("--platform", default=argparse.SUPPRESS,
                   help=platform_help)
    e.set_defaults(fn=_cmd_evaluate)

    s = sub.add_parser("scaleout", help="multi-process scaleout runtime "
                                        "(not ported: ROADMAP.md A10.3)")
    s.add_argument("-t", "--type", choices=("master", "worker", "kill"),
                   default="master")
    s.add_argument("--state-dir", required=True)
    s.add_argument("--performer",
                   default="deeplearning4j_tpu.parallel.performers:WordCountPerformer")
    s.add_argument("--router", default="wordcount",
                   choices=("wordcount", "average"))
    s.add_argument("--jobs", help="master: text file, one job per line")
    s.add_argument("--workers", type=int, default=2)
    s.add_argument("--worker-id", default="worker-0")
    s.add_argument("--max-wall-s", type=float, default=300.0)
    s.set_defaults(fn=_not_ported)

    d = sub.add_parser("dryrun", help="multi-rank sharding dryrun")
    d.add_argument("--devices", type=int, default=8)
    d.add_argument("--platform", default=argparse.SUPPRESS,
                   help=platform_help)
    d.set_defaults(fn=_cmd_dryrun)

    p = sub.add_parser("provision",
                       help="render or execute a pod-slice bring-up "
                            "(not ported: ROADMAP.md A10.3)")
    p.add_argument("--name", default="dl4j-tpu-slice")
    p.add_argument("--accelerator-type", default="v5litepod-64")
    p.add_argument("--zone", default="us-west4-a")
    p.add_argument("--spot", action="store_true")
    p.add_argument("--repo-url", default="")
    p.add_argument("--train-argv", default="-m deeplearning4j_tpu train")
    p.add_argument("--out", help="write the script here instead of stdout")
    p.add_argument("--apply", action="store_true")
    p.add_argument("--dry-run-apply", action="store_true")
    p.add_argument("--kill", action="store_true")
    p.set_defaults(fn=_not_ported)

    ap.add_argument("--platform", default="cuda", help=platform_help)
    args = ap.parse_args(argv)
    if args.fn is not _not_ported:
        from .device import resolve_device
        args.device = resolve_device(args.platform)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
