"""How far the CPU's own DL4J fits move with the thread count.

``chip_smoke.py::run_dl4j`` holds the card's mlp and LeNet fits against
the CPU's.  This script measures, on the CPU alone, how well conditioned
each way of holding them is: the same fit from the same parameters on
the same data (``chip_smoke``'s seeded MNIST-shaped files, its first
batch normalized and shuffled as ``run_dl4j`` makes it), run once per
thread count, each run in a process of its own, and compared with the
first thread count's run.  For each case it prints one JSON line: the
float32 fit after its first iteration and after all of them, the
float32 loss and gradients at the starting parameters, and the whole
fit in float64 (``chip_smoke.params_err``: the max over the parameter
leaves of max |a - b| / max |b|; gradients the same over their leaves).

    python3 dl4j_cpu_spread.py [--threads 8,1,2,3,4,6] [--repeat 1]

``--repeat N`` runs each thread count N times (a run that does not
reproduce shows as a spread between repeats).  CPU only; about a minute
at the defaults.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CASES = {"mlp": 50, "lenet": 10}


def _data(np, cache: Path):
    """``run_dl4j``'s mlp rows (the CLI batch's first 2048) and LeNet
    images (512 raw), written once to ``cache``."""
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.datasets import (MnistDataFetcher,
                                                   MnistDataSetIterator,
                                                   mnist_idx)

    if not cache.exists():
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp) / "mnist"
            cs.write_mnist(np, mnist_idx, root)
            it = MnistDataSetIterator(batch=cs.DL4J_ROWS, data_dir=root)
            ds = it.next().normalize_zero_mean_unit_variance().shuffle(seed=42)
            raw = MnistDataFetcher(binarize=False, flatten=False,
                                   data_dir=root)
            raw.fetch(512)
            im = raw.next()
        np.savez(cache, mf=ds.features[:2048], ml=ds.labels[:2048],
                 lf=im.features, ll=im.labels)
    return np.load(cache)


def one_run(case: str, threads: int, cache: Path, out: Path) -> None:
    """Fit ``case`` at ``threads`` threads and save what is compared."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.ops import dtypes
    from deeplearning4j_tpu_torch.utils import tree_math as tm
    from deeplearning4j_tpu_torch.utils.autodiff import value_and_grad

    torch.set_num_threads(threads)
    d = _data(np, cache)
    ds = (DataSet(d["mf"], d["ml"]) if case == "mlp"
          else DataSet(d["lf"], d["ll"]))

    def build(iterations):
        if case == "mlp":
            return zoo.mlp(784, 10, num_iterations=iterations, device="cpu")
        return zoo.lenet(10, num_iterations=iterations, device="cpu")

    saved = {}

    def keep(tag, tree):
        for i, leaf in enumerate(tm.tree_leaves(tree)):
            saved[f"{tag}/{i}"] = leaf.detach().double().numpy()

    net = build(1)
    net.init(0)
    loss, grads = value_and_grad(net.supervised_loss)(
        net.params, net._tensor(ds.features), net._tensor(ds.labels))
    keep("start_loss", [loss.reshape(1)])
    keep("start_grads", grads)
    net.fit(ds)
    keep("f32_first_iteration", net.params)
    net = build(CASES[case])
    net.init(0)
    net.fit(ds)
    keep("f32_fit", net.params)
    dtypes.set_policy(torch.float64, torch.float64)
    net = build(CASES[case])
    net.init(0)
    net.fit(ds)
    keep("f64_fit", net.params)
    np.savez(out, **saved)


def spread(np, a, b, tag: str) -> float:
    keys = sorted(k for k in a.files if k.startswith(tag + "/"))
    return max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
               for k in keys)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="8,1,2,3,4,6",
                    help="thread counts; the first is the reference")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--one", nargs=3, metavar=("CASE", "THREADS", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.one:
        one_run(args.one[0], int(args.one[1]),
                Path(os.environ["DL4J_SPREAD_CACHE"]), Path(args.one[2]))
        return 0
    with tempfile.TemporaryDirectory(prefix="dl4j_spread_") as tmp:
        cache = Path(tmp) / "data.npz"
        import numpy as np

        _data(np, cache)
        threads = [int(t) for t in args.threads.split(",")]
        env = dict(os.environ, DL4J_SPREAD_CACHE=str(cache))
        for case in CASES:
            runs = {}
            for t in threads:
                for r in range(args.repeat):
                    out = Path(tmp) / f"{case}_{t}_{r}.npz"
                    subprocess.run([sys.executable, __file__, "--one", case,
                                    str(t), str(out)], check=True, env=env,
                                   cwd=ROOT)
                    runs[(t, r)] = np.load(out)
            ref = runs[(threads[0], 0)]
            rows = {f"{t}x{r}": {tag: spread(np, run, ref, tag) for tag in (
                "start_loss", "start_grads", "f32_first_iteration",
                "f32_fit", "f64_fit")}
                for (t, r), run in runs.items() if (t, r) != (threads[0], 0)}
            print(json.dumps({"case": case, "iterations": CASES[case],
                              "reference_threads": threads[0],
                              "cpu_count": os.cpu_count(),
                              "vs_reference": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
