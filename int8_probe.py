#!/usr/bin/env python3
"""Probes of the port's ``int8_matmul`` kernel on one NVIDIA GPU.

    python3 int8_probe.py [--root DIR] [--sweep] [--timeline] [--host]
                          [--engines] [--report PATH]

Measurements behind the kernel's launch plan and ``PERF.md``, at the six
shapes ``chip_smoke.py`` times (M in {1, 8} over the flagship's FFN and
LM-head weights, bf16 x, weights cycled past the L2 cache, device time
of CUDA-graph replays):

- ``--sweep``: the kernel under other launch plans than ``_plan``'s
  (column tile 2/4/8 threads across x cluster 1-8), each checked against
  the plain version and timed;
- ``--timeline``: an instrumented copy of ``csrc/int8_matmul.cu`` (built
  here, into the build directory) stamps ``%globaltimer`` per block at
  each phase of one call: start, x staged, weights consumed, block
  reduced, merge pushed, cluster barrier passed, stored.  Printed as
  min / median / max over the blocks, in ns from the first block's
  start, the median over 5 calls; beside it the device time of an empty
  kernel on the same grid, launched plainly and with the cluster launch
  attribute (the plan's cluster size), i.e. the launch's share;
- ``--host``: the host's cost of one eager call (enqueue only), against
  ``torch.matmul`` on the dequantized weight; with ``--timeline``, also
  of one empty-kernel launch: plain, with the cluster launch attribute,
  and with the cluster size compiled in (``__cluster_dims__``).

- ``--engines``: ``chip_smoke.py``'s engines A and B (same configs,
  requests and seeds) after whatever the flags above ran in this
  process: TTFT, prefill and decode-step p50, wall time.  Alone, they
  measure the serving path without ``chip_smoke.py``'s kernel phase
  before them; after ``--sweep``, with the sweep's CUDA-graph replays of
  the kernel before them.

``--root`` picks the checkout whose ``deeplearning4j_tpu_torch`` runs
(this one by default).  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = [(m, k, n) for m in (1, 8)
          for k, n in ((768, 3072), (3072, 768), (768, 32768))]
PHASES = ("start", "x staged", "K loop", "block reduced", "pushed",
          "cluster barrier", "stored")

# the instrumented copy: (text of csrc/int8_matmul.cu, text it becomes)
_LOOP = "    for (; k < k1; k += kUnroll * groups) {\n"
_STAMPS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_stamps[16384 * 8];\n"
     "#define STAMP(i) do { if (threadIdx.x == 0 && bid < 16384) { "
     "unsigned long long t; asm volatile(\"mov.u64 %0, %globaltimer;\" : "
     "\"=l\"(t)); g_stamps[bid * 8 + (i)] = t; } } while (0)\n"),
    ("                 int M, int K, int N, int block_n, int k_chunk) {\n",
     "                 int M, int K, int N, int block_n, int k_chunk) {\n"
     "  const int bid = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * "
     "blockIdx.z);\n  STAMP(0);\n"),
    ("    __syncthreads();\n" + _LOOP,
     "    __syncthreads();\n    STAMP(1);\n" + _LOOP),
    ("  // the row groups of a warp (lanes tpr apart)",
     "  STAMP(2);\n  // the row groups of a warp (lanes tpr apart)"),
    ("  asm volatile(\"barrier.cluster.wait.aligned;\" ::: \"memory\");\n",
     "  asm volatile(\"barrier.cluster.wait.aligned;\" ::: \"memory\");\n"
     "  STAMP(3);\n"),
    ("  cluster.sync();\n", "  STAMP(4);\n  cluster.sync();\n  STAMP(5);\n"),
]


def fail(msg: str) -> None:
    print(f"int8_probe: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def instrumented_source(src: str) -> str:
    """``csrc/int8_matmul.cu`` with per-block phase stamps, an empty
    kernel and two C entry points to read the stamps and time the empty
    kernel."""
    out = src
    for anchor, text in _STAMPS:
        if out.count(anchor) != 1:
            fail(f"the kernel source changed: {anchor.strip()!r} is not "
                 "there once")
        out = out.replace(anchor, text)
    end = out.index("template <typename T, int MT, int VEC, bool kAligned>\n"
                    "cudaError_t launch_one")
    close = out.rindex("}\n", 0, end)
    out = (out[:close] + "  STAMP(6);\n}\n\n"
           "__global__ void empty_kernel() {}\n" + out[close + 2:])
    return out + """
__global__ void __cluster_dims__(8, 1, 1) empty_cluster8_kernel() {}
extern "C" int dl4j_probe_empty_static8(int gy, void* stream) {
  empty_cluster8_kernel<<<dim3(8, gy, 1), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
extern "C" int dl4j_probe_stamps(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, g_stamps, sizeof(unsigned long long) * 8 * n));
}
extern "C" int dl4j_probe_empty(int gx, int gy, int gz, int cluster,
                                int with_attr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!with_attr) {
    empty_kernel<<<dim3(gx, gy, gz), 256, 0, s>>>();
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, gz);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, empty_kernel));
}
"""


def build_instrumented(build) -> ctypes.CDLL:
    out_dir = build.build_dir() / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "int8_matmul_probe.cu"
    src.write_text(instrumented_source(
        (build.CSRC / "int8_matmul.cu").read_text()))
    lib = out_dir / "libint8_matmul_probe.so"
    cmd = [build.nvcc_path(), *build.ARCH_FLAGS, *build.NVCC_FLAGS,
           "-I", str(build.CSRC), "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"nvcc failed on the instrumented copy:\n{proc.stdout}"
             f"{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.dl4j_int8_matmul.argtypes = [P, I, P, P, P] + [I] * 7 + [P]
    dll.dl4j_probe_stamps.argtypes = [P, I]
    dll.dl4j_probe_empty.argtypes = [I, I, I, I, I, P]
    dll.dl4j_probe_empty_static8.argtypes = [I, P]
    return dll


def operands(torch, tmm, cs, m, k, n, gen):
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    qws = [tmm.quantize(w * (1 + 0.01 * i))
           for i in range(cs.copies_for(k * n))]
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    return x, qws


def sweep(torch, tmm, cs, gen) -> list:
    rows = []
    for m, k, n in SHAPES:
        x, qws = operands(torch, tmm, cs, m, k, n, gen)
        ref = tmm.reference_int8_matmul(x, qws[0])
        default = tmm._plan(m, k, n, 132)
        plans = [default]
        for tpr, cl in itertools.product((2, 4, 8), (1, 2, 3, 4, 6, 8)):
            kc = -(-k // cl)
            p = tmm.Plan(default.vec * tpr, default.row_tile, -(-k // kc), kc)
            if p not in plans:
                plans.append(p)
        plan_fn = tmm._plan
        try:
            for p in plans:
                tmm._plan = lambda *_, p=p: p
                err = (tmm.int8_matmul(x, qws[0]) - ref).abs().max().item()
                ms = cs.device_ms(torch, [lambda qw=qw: tmm.int8_matmul(x, qw)
                                          for qw in qws])
                blocks = p.cluster * -(-n // p.block_n) * -(-m // p.row_tile)
                rows.append({"M": m, "K": k, "N": n, "plan": list(p),
                             "blocks": blocks, "ms": ms, "max_abs_err": err,
                             "plan_default": p == default})
                print(f"sweep M={m} K={k} N={n} plan={tuple(p)} blocks="
                      f"{blocks} ms={ms:.5f} err={err:.2g}"
                      f"{' (_plan)' if p == default else ''}", flush=True)
        finally:
            tmm._plan = plan_fn
    return rows


def timeline(torch, tmm, cs, dll, gen) -> dict:
    import numpy as np

    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for m, k, n in SHAPES:
        x, qws = operands(torch, tmm, cs, m, k, n, gen)
        p = tmm._plan(m, k, n, 132)
        grid = (p.cluster, -(-n // p.block_n), -(-m // p.row_tile))
        blocks = grid[0] * grid[1] * grid[2]
        res = torch.empty((m, n), dtype=torch.float32, device="cuda")

        def call(qw):
            rc = dll.dl4j_int8_matmul(x.data_ptr(), 1, qw.q.data_ptr(),
                                      qw.scale.data_ptr(), res.data_ptr(), m,
                                      k, n, *p, stream)
            if rc:
                fail(f"instrumented launch: CUDA error {rc}")

        runs = []
        for _ in range(5):
            for qw in qws[1:]:           # qws[0] is cold again
                call(qw)
            call(qws[0])
            torch.cuda.synchronize()
            buf = np.zeros((blocks, 8), np.uint64)
            dll.dl4j_probe_stamps(buf.ctypes.data, blocks)
            t = buf[:, :7].astype(np.int64)
            t -= t[:, 0].min()
            runs.append(np.percentile(t, (0, 50, 100), axis=0))
        med = np.median(np.stack(runs), axis=0)     # (3, 7)
        err = (res - tmm.reference_int8_matmul(x, qws[0])).abs().max().item()
        def launch_empty(attr):
            rc = dll.dl4j_probe_empty(*grid, p.cluster, attr,
                                      torch.cuda.current_stream().cuda_stream)
            if rc:
                fail(f"empty kernel: CUDA error {rc}")

        empty = {how: cs.device_ms(torch, [lambda a=attr: launch_empty(a)]
                                   * 50)
                 for how, attr in (("plain", 0), ("cluster attribute", 1))}
        phases = {ph: [int(v) for v in med[:, i]]
                  for i, ph in enumerate(PHASES)}
        out[f"M={m} K={k} N={n}"] = {"plan": list(p), "blocks": blocks,
                                     "empty_kernel_ms": empty,
                                     "max_abs_err": err, "phases_ns": phases}
        print(f"timeline M={m} K={k} N={n} plan={tuple(p)} blocks={blocks}"
              f" err={err:.2g}: an empty kernel on the grid, ms: "
              + ", ".join(f"{h} {v:.5f}" for h, v in empty.items()),
              flush=True)
        for ph, v in phases.items():
            print(f"  {ph:16s} ns min/median/max {v}", flush=True)
    return out


def enqueue_us(torch, fn, calls: int = 500) -> float:
    """Host time to enqueue one call, best of 5 runs of ``calls`` (few
    enough that the launch queue does not fill and block)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def host(torch, tmm, gen, dll=None) -> dict:
    out = {}
    for m, k, n in SHAPES:
        qw = tmm.quantize(torch.randn((k, n), generator=gen, device="cuda")
                          * k ** -0.5)
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = tmm.dequantize(qw).to(torch.bfloat16)
        res = {"int8_matmul": enqueue_us(
                   torch, lambda: tmm.int8_matmul(x, qw)),
               "torch.matmul": enqueue_us(
                   torch, lambda: torch.matmul(x, w))}
        out[f"M={m} K={k} N={n}"] = res
        print(f"host M={m} K={k} N={n}: us to enqueue one call: "
              + ", ".join(f"{a} {b:.2f}" for a, b in res.items()), flush=True)
    if dll is not None:     # the launch alone: an empty kernel, 96 blocks
        stream = torch.cuda.current_stream().cuda_stream
        res = {how: enqueue_us(torch, lambda c=c, a=a: dll.dl4j_probe_empty(
                   c, 96 // c, 1, c, a, stream))
               for how, c, a in (("plain", 1, 0),
                                 ("cluster attribute of 1", 1, 1),
                                 ("clusters of 8", 8, 1))}
        res["clusters of 8 by __cluster_dims__"] = enqueue_us(
            torch, lambda: dll.dl4j_probe_empty_static8(12, stream))
        out["empty kernel, 96 blocks"] = res
        print("host empty kernel, 96 blocks: us to enqueue one launch: "
              + ", ".join(f"{a} {b:.2f}" for a, b in res.items()), flush=True)
    return out


def engines(torch, cs, root) -> dict:
    import inspect

    import numpy as np
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.ops.cuda import build
    from deeplearning4j_tpu_torch.observability import METRICS
    from deeplearning4j_tpu_torch.serving import engine as eng

    build.build_all()
    METRICS.reset()
    mcfg = ttr.TransformerConfig()
    model = ttr.TransformerLM(mcfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    # the parent tree's engine takes cfg third, positionally
    by_kw = "checkpoint" in inspect.signature(eng.InferenceEngine).parameters
    out = {}
    for label, kw, n_req in (
            ("A", {"paged_attention_impl": "pallas"}, 16),
            ("B", {"kv_quant": "int8", "paged_attention_impl": "pallas_int8"},
             8)):
        cfg = eng.ServingConfig(slots=8, paged=True, page_size=16,
                                int8_decode=True, **kw)
        engine = (eng.InferenceEngine(model, params, cfg=cfg, device="cuda")
                  if by_kw else
                  eng.InferenceEngine(model, params, cfg, device="cuda"))
        engine.start()
        prompts = [rng.integers(0, mcfg.vocab_size, int(rng.integers(
            cs.PROMPT_TOKENS[0], cs.PROMPT_TOKENS[1] + 1))).tolist()
            for _ in range(n_req)]
        t0 = time.perf_counter()
        for h in [engine.submit(p, cs.NEW_TOKENS) for p in prompts]:
            h.result(timeout=600)
        wall = time.perf_counter() - t0
        # an older tree's engine has a registry of its own; a newer one
        # publishes to the process-wide METRICS (reset before each engine)
        registry = getattr(engine, "metrics", None) or METRICS
        timers = registry.snapshot()["timers"]
        engine.stop()
        if registry is METRICS:
            METRICS.reset()
        out[label] = {"wall_s": wall,
                      "ttft_p50_s": timers["serving.ttft"]["p50_s"],
                      "prefill_p50_s": timers["serving.prefill"]["p50_s"],
                      "decode_step_p50_s":
                          timers["serving.decode_step"]["p50_s"]}
        print(f"engines {label} ({root.name}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in out[label].items()), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--engines", action="store_true")
    ap.add_argument("--report", help="also write the results (JSON) here")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this probe needs a GPU")
    root = Path(args.root).resolve()
    if not (root / "deeplearning4j_tpu_torch" / "csrc").is_dir():
        fail(f"{root} holds no deeplearning4j_tpu_torch checkout")
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops.cuda import build
    from deeplearning4j_tpu_torch.ops.cuda import matmul_int8 as tmm

    build.load("int8_matmul")
    gen = torch.Generator(device="cuda").manual_seed(1)
    result = {"card": cs.card_line(), "root": str(root)}
    print(f"card: {result['card']} | root {root}", flush=True)
    if args.sweep:
        result["sweep"] = sweep(torch, tmm, cs, gen)
    dll = None
    if args.timeline:
        dll = build_instrumented(build)
        result["timeline"] = timeline(torch, tmm, cs, dll, gen)
    if args.host:
        result["host_us"] = host(torch, tmm, gen, dll)
    if args.engines:
        result["engines"] = engines(torch, cs, root)
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
