#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]
    python3 chip_smoke.py --paged-only [--root DIR] [--report PATH]
    python3 chip_smoke.py --int8-only [--root DIR] [--report PATH]

Builds the port's CUDA kernels from ``deeplearning4j_tpu_torch/csrc`` (one
``nvcc`` per source, started together), holds each kernel against its
plain PyTorch version at the shapes of the port's main paths (paged int8
serving and the flagship train step), then drives those paths through the
entry points a user calls:

1. the card (``nvidia-smi`` name and power limit), the build time and
   every kernel's registers, spills and static shared memory (``ptxas -v``);
2. ``int8_matmul`` at M in {1, 4, 8, 32} (a prefill token, beam search's
   width, the engines' slots, a speculative verify window) over the FFN
   and LM-head weights (and its input gradient at the FFN shapes against
   the plain version's; and, under ``torch.profiler``, that a call at each
   of those shapes is one device kernel), and
   ``paged_attention`` / ``paged_attention_int8`` at B=8, H=12, Dh=64,
   page 16, 128 pages per row: at the engines' own lengths (16-288
   positions, Kv=12, the main-path case) and at long-context lengths of
   1-2048 (Kv in {12, 4}); then the forward kernels: ``flash_attention`` and
   ``fused_attention`` (causal and not) at the two training legs' shapes
   (B=64, T=512 and B=8, T=2048; H=12, Dh=64), at the full-forward
   sampler's (B=1, T=2048, causal) and the scorer's (B=32, T=512),
   ``fused_residual_layernorm`` at N in {32768, 16384, 2048} rows of 768
   (beside ``F.layer_norm`` over a precomputed sum and the transformer's
   own two-op seam) and ``blocked_cross_entropy`` at N in {32768, 16384}
   against the tied 32768 x 768 head (also timed with two vocabulary
   splits against the default) — each in bf16 (and float32 for the error
   alone) against its plain version run in float32 on the same values,
   with the times of the kernel, its plain version and a one-call PyTorch
   yardstick beside the least time the card could take;
3. engine A: ``InferenceEngine`` at the full width of the default
   ``TransformerConfig`` (random weights from a seed) with
   ``ServingConfig(slots=8, paged=True, page_size=16, int8_decode=True,
   paged_attention_impl="pallas")`` serving 16 concurrent greedy requests,
   the kernels' launch counts over that run, and teacher-forced decode
   steps with the kernels against the same steps with the plain versions,
   in bf16 and in float32;
4. ``ModelServer`` over engine A answering 2 requests via ``ServingClient``;
5. engine B: as A with ``kv_quant="int8", paged_attention_impl=
   "pallas_int8"`` and 8 requests;
6. engine S: as A with ``speculative=True, spec_k=3`` and the random
   one-layer ``zoo.draft_lm`` draft, on A's prompts (tokens/s, TTFT, the
   step, ``serving.spec_accept_len``, its served tokens against A's), and
   teacher-forced verify windows (``decode_window_paged``, ``int8_matmul``
   at M=32) against sequential steps through the plain versions, in bf16
   and float32;
7. the prefix cache: 16 requests sharing a 128-token system prompt (with
   suffixes of 16-128 tokens, 16 new tokens each) on A's and on B's
   config with ``prefix_cache=True`` against the same with ``False``:
   the hit rate, and float pages' tokens equal;
8. ``beam_search`` at width 4, 8 tokens, over the int8 serving tree;
9. ``sample(kv_cache=False)`` against ``kv_cache=True``, greedy, 8 tokens,
   on the default causal config with ``attention="fused",
   fused_ln=True``, in bf16 (the launches) and float32 (tokens equal);
10. a ``BatchScorer`` over ``forward_local`` at leg A's config behind
   ``ModelServer``: 32 rows through ``ServingClient.score``, held to
   direct calls of one row;
11. training leg A, the BERT-base leg of the JAX package's benchmark
   (vocab 32768, d_model 768, 12 heads, 12 layers, d_ff 3072, T=512,
   bidirectional, bf16, no remat, ``attention="flash", fused_ln=True,
   xent_impl="blocked"``): ``TransformerLM.build_train_step(adamw(
   warmup_cosine(1e-4, 10, 1000), weight_decay=0.01))`` at batch 64 x 512,
   one warm-up and five timed steps (p50 step time, tokens/s, MFU, the
   loss of every step, the launch counts against what the config implies)
   and one more step under ``torch.profiler`` (device time by kernel and
   by class: the port's kernels, f32 GEMMs, tensor-core GEMMs, the rest);
12. training leg B, the default causal ``TransformerConfig`` (T=2048,
   remat) with ``attention="fused", fused_ln=True, xent_impl="blocked"`` at
   batch 8 x 2048, one warm-up, three timed steps and one profiled;
13. one train step's loss and gradients through the kernels against the
   same through every plain version, on one state at batch 4 x 512, for
   both legs' configs, in bf16 and float32;
14. checkpoints, the trainer and hot reload (``run_checkpoints``) on leg
   B's config at 8 x 512: a determinism probe (one step twice from one
   state); ``DataParallelTrainer`` under ``TrainingSupervisor`` with a
   ``CheckpointManager(keep=2)`` (full-width saves of params and both
   Adam moments), 8 steps, a checkpoint every 2, a bit flipped in the
   step-4 save, a failed step 5 and a failed batch 7, held to the
   fault-free run (bitwise, or within ``TOL_CHAOS`` if the probe finds a
   step not bitwise repeatable); ``InferenceEngine(checkpoint=dir)``
   (engine A's config) behind ``ModelServer`` serving 8 greedy requests;
   two more steps publishing step 10, and ``ServingClient.reload()`` while
   8 requests decode: their stamps and tokens stay step 8's, and 8 later
   requests carry step 10's and equal a fresh engine's on step 10;
15. a ``{"kernels": [...]}`` JSON line (each path's launches counted from
   0 just before it runs, read just after), then the card's name and
   power limit, then ``{"ok": true, "device": {...}}`` as the last line.

``--paged-only`` builds ``csrc/paged_attention.cu`` of the checkout at
``--root`` (this script's by default) and runs phase 2's paged cases
alone, printing them as one JSON line: two such runs on one card time
two versions of the kernel against each other.  ``--int8-only`` does the
same for ``csrc/int8_matmul.cu``: its twelve shapes, its input gradient and
its device kernels a call (reported there, not held to one, so that an
older tree can be timed beside a newer one).

Any failed phase exits non-zero without the last line, as does a machine
without CUDA or a directory without the rest of the repository.  Device
times come from CUDA events around CUDA-graph replays of many launches,
cycling over enough copies of the operands to exceed the 50 MB L2 cache
(a decode step finds its weights and pages cold); the plain versions and
yardsticks of the training kernels, tens of ms each, are timed with CUDA
events around eager calls.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# tolerances, each set from the error the kernel shows against its plain
# version with room to spare, so that a wrong kernel fails (the registry's
# wider bands decide adoption, not this check)
# int8_matmul: f32 out from bf16 or f32 x; only the summation order differs
TOL_INT8 = 1e-4
# paged attention, f32 q and pools: only the summation order differs
TOL_ATTN_F32 = 1e-4
# paged attention, bf16 out, against the plain version run in float32 on
# the same (upcast) values: the kernel accumulates in f32 and rounds once
# to bf16, so it must lie within half a unit in the last place,
# |out - ref| <= ATOL + RTOL * |ref|.  (The plain version in bf16 rounds
# its softmax weights, and its int8 kind the dequantized pages, to bf16,
# which moves short rows by several units: no yardstick for a kernel.)
TOL_ATTN_BF16 = (1e-5, 2 ** -8)
# teacher-forced step: max |logit difference|, float32 and bf16 compute
TOL_LOGITS_F32 = 1e-3
TOL_LOGITS_BF16 = 0.05
# teacher-forced step, kernels vs plain versions: top-1 agreement.  In
# float32 compute the two differ by summation order only, so they must
# agree on top-1.  In bf16 the residual stream rounds at every layer and
# any change of rounding, however small, flips about 1-3% of the argmaxes
# of this random-weight model (whose top-2 logit gap is below 0.002 for 1%
# of rows): the int8 kernel alone, whose output differs from its plain
# version by ~1e-6, flipped 5 of 384 rows on an H100.  So the bf16 run is
# held to the bf16 logits tolerance and to a top-1 floor that leaves room for
# that noise and no more.
TOL_TOP1 = 0.99          # float32 compute
TOL_TOP1_BF16 = 0.95     # bf16 compute (the engines' dtype)
# flash/fused attention against the plain version run in float32 on the
# same values.  f32 kernel, out and lse: summation order only (measured
# 9.5e-7, one ulp of the lse).  bf16: the kernel rounds each softmax weight
# p to bf16 for the tensor-core P V, which moves the output by at most half
# a unit in the last place of sum(p |v|) / l, and rounds the output once,
# half a unit of |out|: held to |out - ref| <= ATOL + RTOL * (sum(p |v|) / l
# + |ref|), the plain version run on |v| giving the first term
TOL_FLASH_F32 = 1e-5
TOL_FLASH_BF16 = (1e-5, 2 ** -8)
# residual + LayerNorm: bf16 outputs within half a unit in the last place
# of the f32 values (plus the f32 summation order); f32 outputs (measured
# 1.4e-6 where |h| reaches ~5)
TOL_LN_BF16 = (1e-5, 2 ** -8)
TOL_LN_F32 = 1e-5
# blocked xent, per-token loss and lse (~10.5): bf16 products are exact in
# the f32 accumulators, so bf16 and f32 differ from the plain version by
# summation order only (measured 3.8e-6, four ulps)
TOL_XENT = 2e-5
# one train step at 4 x 512, kernels vs plain versions: (loss relative
# error, max over the leaves of max |grad difference| / max |plain grad|).
# f32: summation order (measured 0 and 1.8e-6).  bf16: the rounding of P
# and of every bf16 activation downstream of it (measured 8.3e-6 and
# 0.017 on an H100)
TOL_STEP_F32 = (1e-6, 2e-5)
TOL_STEP_BF16 = (1e-4, 0.05)
# a scored row (log-probabilities through forward_local) against a direct
# call of that row alone: the attention tolerance of the kernel registry
TOL_SCORE = 0.05

#: the training kernels' wrappers, by the kernels line's names
TRAIN_KERNELS = ("flash_attention", "fused_attention",
                 "fused_residual_layernorm", "blocked_cross_entropy")
#: rows of the LN and xent calls in the two training legs (64 x 512,
#: 8 x 2048) and the checkpoint phase (8 x 512)
TRAIN_ROWS = (32768, 16384, 4096)
#: rows of the LN calls: the training legs' (the scorer's 32 x 512 is leg
#: B's count) and the full-forward sampler's one row of 2048
LN_ROWS = TRAIN_ROWS + (2048,)

# the card's rates for the least-time bound, by product name
RATES = {  # name fragment: (bytes/s, bf16 dense ops/s)
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H200": (4.8e12, 989e12),
    "H100": (3.35e12, 989e12),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rates_for(name: str) -> tuple[float, float]:
    for frag, r in RATES.items():
        if frag in name:
            return r
    fail(f"no memory/compute rates known for {name!r}")


# ------------------------------------------------------------------ timing

def device_ms(torch, fns, reps: int = 20) -> float:
    """Mean device time of one call: ``fns`` are closures over operand
    copies (cycled so the working set exceeds L2); ``reps`` passes over
    them are captured in one CUDA graph and the replay is timed with CUDA
    events."""
    for fn in fns:                       # warm up (and allocate) eagerly
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                for fn in fns:
                    fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * len(fns))
    del graph
    return ms


def copies_for(nbytes: int, floor: int = 2) -> int:
    """Operand copies whose total exceeds the 50 MB L2 twice over."""
    return max(floor, -(-100_000_000 // max(nbytes, 1)))


# ------------------------------------------------------------------ kernels

#: int8_matmul's rows on the main paths: a prefill token (1), beam search
#: (the beam width, 4), a decode step (the engines' 8 slots) and a
#: speculative verify window (8 slots x (spec_k + 1) = 32)
INT8_ROWS = (1, 4, 8, 32)


def check_int8(torch, tmm, dev, rates, cases):
    gen = torch.Generator(device=dev).manual_seed(1)
    bw, peak = rates
    for m, (k, n) in [(m, s) for m in INT8_ROWS
                      for s in ((768, 3072), (3072, 768), (768, 32768))]:
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        ncopy = copies_for(k * n)
        qws = [tmm.quantize(w * (1 + 0.01 * i)) for i in range(ncopy)]
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        err = 0.0
        for xx in (x, x.float()):
            out = tmm.int8_matmul(xx, qws[0])
            ref = tmm.reference_int8_matmul(xx, qws[0])
            torch.cuda.synchronize()
            e = (out - ref).abs().max().item()
            if not (e < TOL_INT8 and torch.isfinite(out).all().item()):
                fail(f"int8_matmul M={m} K={k} N={n} x {xx.dtype}: max err "
                     f"{e} (tol {TOL_INT8})")
            err = max(err, e)
        wdeq = [tmm.dequantize(qw).to(torch.bfloat16) for qw in qws]
        ms = device_ms(torch, [lambda qw=qw: tmm.int8_matmul(x, qw)
                               for qw in qws])
        plain = device_ms(torch, [lambda qw=qw: tmm.reference_int8_matmul(
            x, qw) for qw in qws], reps=5)
        lib = device_ms(torch, [lambda w_=w_: torch.matmul(x, w_)
                                for w_ in wdeq], reps=5)
        nbytes = m * k * 2 + k * n + n * 4 + m * n * 4
        ops = 2 * m * k * n
        bound = max(nbytes / bw, ops / peak) * 1e3
        cases.append({"kernel": "int8_matmul", "M": m, "K": k, "N": n,
                      "max_abs_err": err, "tol": TOL_INT8, "ms": ms,
                      "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                      "bound_by": "bytes" if nbytes / bw >= ops / peak
                      else "operations", "bytes": nbytes, "ops": ops})
        print(f"kernel int8_matmul M={m} K={k} N={n}: max_err={err:.3g} "
              f"(tol {TOL_INT8}) kernel_ms={ms:.5f} plain_ms={plain:.5f} "
              f"library_ms={lib:.5f} bound_ms={bound:.5f}", flush=True)
        del qws, wdeq


def check_int8_grad(torch, tmm, dev, M=8):
    """dx through ``int8_matmul`` (the kernel forward, the torch-op
    backward) against dx through its plain version, at the FFN shapes,
    float32 x: the two differ by summation order only."""
    gen = torch.Generator(device=dev).manual_seed(9)
    errs = {}
    for k, n in ((768, 3072), (3072, 768)):
        qw = tmm.quantize(torch.randn((k, n), generator=gen, device=dev)
                          * k ** -0.5)
        x = torch.randn((M, k), generator=gen, device=dev)
        c = torch.randn((M, n), generator=gen, device=dev)
        grads = []
        for fn in (tmm.int8_matmul, tmm.reference_int8_matmul):
            xx = x.clone().requires_grad_(True)
            (fn(xx, qw) * c).sum().backward()
            grads.append(xx.grad)
        torch.cuda.synchronize()
        e = (grads[0] - grads[1]).abs().max().item()
        if not (e < TOL_INT8 and torch_isfinite(grads[0])):
            fail(f"int8_matmul dx M={M} K={k} N={n}: max err {e} "
                 f"(tol {TOL_INT8})")
        errs[f"{k}x{n}"] = e
    print(f"kernel int8_matmul dx (FFN shapes, M={M}, f32): max_err {errs} "
          f"(tol {TOL_INT8})", flush=True)
    return errs


def check_int8_one_launch(torch, tmm, dev, tries: int = 3):
    """Device kernels that one ``int8_matmul`` call launches, under
    ``torch.profiler``, at each of phase 2's twelve shapes (w2 at M=1 splits
    K over a cluster): ``{shape: [kernel names]}``.  A session that saw
    no kernel is taken again, up to ``tries`` times (CUPTI has dropped
    a short session's only record on an H100); more than one is kept.
    The run calls it before any other profiler session: after the train
    legs' sessions in the same process, sessions recorded no kernel at
    all."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for m, (k, n) in [(m, s) for m in INT8_ROWS
                      for s in ((768, 3072), (3072, 768), (768, 32768))]:
        qw = tmm.quantize(torch.randn((k, n), generator=gen, device=dev)
                          * k ** -0.5)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        tmm.int8_matmul(x, qw)
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tmm.int8_matmul(x, qw)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            if names:
                break
        out[f"M={m} K={k} N={n}"] = names
    print("kernel int8_matmul device kernels a call (torch.profiler): "
          + ", ".join(f"{s}: {len(v)}" for s, v in out.items()), flush=True)
    return out


#: the engines' requests (``run_engine``): prompts of 16-256 tokens, 32 new
#: tokens each; so a row attends over 16-288 positions in a decode step
PROMPT_TOKENS = (16, 256)
NEW_TOKENS = 32
ENGINE_LENGTHS = (PROMPT_TOKENS[0], PROMPT_TOKENS[1] + NEW_TOKENS)
#: the long-context paged cases: lengths over the whole 128-page table
LONG_LENGTHS = (1, 2048)


def paged_inputs(torch, dev, gen, Kv, quant, B=8, H=12, Dh=64, ps=16,
                 n_pages=128, lengths_range=LONG_LENGTHS):
    P = B * n_pages + 1
    trash = P - 1
    lo, hi = lengths_range
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device=dev)
    if lengths_range == LONG_LENGTHS:
        lengths[0], lengths[1] = 1, n_pages * ps   # both extremes
    perm = torch.randperm(P - 1, generator=gen, device=dev)
    bt = perm[:B * n_pages].reshape(B, n_pages).to(torch.int32)
    need = (lengths + ps - 1) // ps
    bt = torch.where(torch.arange(n_pages, device=dev)[None, :]
                     < need[:, None], bt, torch.full_like(bt, trash))
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((P, ps, Kv, Dh), generator=gen, device=dev)
    v = torch.randn((P, ps, Kv, Dh), generator=gen, device=dev)
    return q, k, v, bt, lengths.to(torch.int32)


def check_paged(torch, tpa, kv_quant, dev, rates, cases):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(2)
    # the engines' lengths draw from their own generator, so the long
    # cases keep the lengths and values of earlier runs
    gen_engine = torch.Generator(device=dev).manual_seed(4)
    bw, peak = rates
    for quant in (False, True):
        for Kv, lrange in ((12, LONG_LENGTHS), (4, LONG_LENGTHS),
                           (12, ENGINE_LENGTHS)):
            q, k, v, bt, lengths = paged_inputs(
                torch, dev, gen_engine if lrange == ENGINE_LENGTHS else gen,
                Kv, quant, lengths_range=lrange)
            B, H, Dh = q.shape
            P, ps = k.shape[:2]
            s0 = torch.full((P, Kv), 1 / 127, device=dev)
            item = 1 if quant else 2
            valid = int(lengths.long().sum().item())
            # enough copies that both the pools and the pages the rows
            # touch exceed the L2 (short rows touch a few MB of a pool)
            ncopy = max(copies_for(2 * k.numel() * item),
                        copies_for(2 * valid * Kv * Dh * item))
            pools = []
            for i in range(ncopy):
                if quant:
                    kq, ks = kv_quant.requantize_pool(k * (1 + 0.01 * i), s0,
                                                      torch.int8)
                    vq, vs = kv_quant.requantize_pool(v, s0, torch.int8)
                    pools.append((kq, vq, ks, vs))
                else:
                    pools.append((k.to(torch.bfloat16) * (1 + 0.01 * i),
                                  v.to(torch.bfloat16)))
            name = "paged_attention_int8" if quant else "paged_attention"
            kern = tpa.paged_attention_int8 if quant else tpa.paged_attention
            plain = (tpa.reference_paged_attention_int8 if quant
                     else tpa.reference_paged_attention)

            def call(fn, pool):
                if quant:
                    kq, vq, ks, vs = pool
                    return fn(q, kq, vq, ks, vs, bt, lengths)
                return fn(q, pool[0], pool[1], bt, lengths)

            # the kernel in bf16 (the engines' dtype) and in float32, both
            # against the plain version in float32 on the same values
            atol, rtol = TOL_ATTN_BF16
            args32 = (q.float(),) + (pools[0] if quant else tuple(
                t.float() for t in pools[0]))
            ref = plain(*args32, bt, lengths)
            out = call(kern, pools[0])
            torch.cuda.synchronize()
            diff = (out.float() - ref).abs()
            err = diff.max().item()
            if not ((diff <= atol + rtol * ref.abs()).all().item()
                    and torch.isfinite(out).all().item()):
                fail(f"{name} Kv={Kv} bf16: max err {err} (tol {atol} + "
                     f"{rtol} |ref|)")
            e32 = (kern(*args32, bt, lengths) - ref).abs().max().item()
            if not e32 < TOL_ATTN_F32:
                fail(f"{name} Kv={Kv} float32: max err {e32} "
                     f"(tol {TOL_ATTN_F32})")
            # yardstick: SDPA over K/V gathered (and dequantized)
            # beforehand: over the whole table for the long cases (as in
            # earlier runs), over the pages the longest row needs for the
            # engines' lengths (what a caller of SDPA would gather)
            if lrange == ENGINE_LENGTHS:
                T = -(-int(lengths.max().item()) // ps) * ps
            else:
                T = bt.shape[1] * ps
            t = torch.arange(T, device=dev).expand(B, T)
            flat = torch.gather(bt[:, :T // ps].long(), 1, t // ps) * ps \
                + t % ps
            mask = (t < lengths.long()[:, None])[:, None, None, :]
            dense = []
            for pool in pools[:max(2, copies_for(
                    2 * B * T * H * Dh * 2))]:
                if quant:
                    kf = kv_quant.dequantize_pool(pool[0], pool[2],
                                                  torch.bfloat16)
                    vf = kv_quant.dequantize_pool(pool[1], pool[3],
                                                  torch.bfloat16)
                else:
                    kf, vf = pool
                kg = kf.reshape(-1, Kv, Dh)[flat].repeat_interleave(
                    H // Kv, dim=2).transpose(1, 2).contiguous()
                vg = vf.reshape(-1, Kv, Dh)[flat].repeat_interleave(
                    H // Kv, dim=2).transpose(1, 2).contiguous()
                dense.append((kg, vg))
            q4 = q[:, :, None, :]
            ms = device_ms(torch, [lambda p=p: call(kern, p) for p in pools])
            pms = device_ms(torch, [lambda p=p: call(plain, p)
                                    for p in pools[:2]], reps=3)
            lms = device_ms(torch, [
                lambda kg=kg, vg=vg: F.scaled_dot_product_attention(
                    q4, kg, vg, attn_mask=mask) for kg, vg in dense], reps=5)
            nbytes = (2 * valid * Kv * Dh * item + 2 * q.numel() * 2
                      + bt.numel() * 4 + B * 4)
            if quant:
                nbytes += 2 * int(((lengths.long() + ps - 1) // ps).sum()
                                  .item()) * Kv * 4
            ops = 4 * valid * H * Dh
            bound = max(nbytes / bw, ops / peak) * 1e3
            cases.append({"kernel": name, "B": B, "H": H, "Kv": Kv, "Dh": Dh,
                          "page_size": ps, "n_pages": bt.shape[1],
                          "lengths": f"{lrange[0]}-{lrange[1]}",
                          "mean_len": valid / B, "sdpa_positions": T,
                          "max_abs_err": err,
                          "tol": f"{atol} + {rtol} |ref|",
                          "max_abs_err_f32": e32, "tol_f32": TOL_ATTN_F32,
                          "ms": ms, "plain_ms": pms,
                          "library_ms": lms, "bound_ms": bound,
                          "bound_by": "bytes" if nbytes / bw >= ops / peak
                          else "operations", "bytes": nbytes, "ops": ops})
            print(f"kernel {name} B={B} H={H} Kv={Kv} lengths {lrange[0]}-"
                  f"{lrange[1]} mean_len={valid / B:.1f}: max_err bf16={err:.3g} (tol {atol} + {rtol:.4g} |ref|) "
                  f"f32={e32:.3g} (tol {TOL_ATTN_F32}) kernel_ms={ms:.5f} "
                  f"plain_ms={pms:.5f} library_ms={lms:.5f} "
                  f"bound_ms={bound:.5f}", flush=True)
            del pools, dense


def event_ms(torch, fn, reps: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` eager calls (after one
    warm-up), from CUDA events: for calls of many ms, where launch gaps do
    not matter and a CUDA graph of their allocations would not fit."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_of(nbytes: float, ops: float, rates) -> tuple[float, str]:
    bw, peak = rates
    return (max(nbytes / bw, ops / peak) * 1e3,
            "bytes" if nbytes / bw >= ops / peak else "operations")


def within(out, ref, tol) -> tuple[bool, float]:
    """``|out - ref| <= atol + rtol |ref|`` everywhere, finite; and the max
    absolute error."""
    atol, rtol = tol
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all().item()
              and torch_isfinite(out))
    return ok, diff.max().item()


def torch_isfinite(t) -> bool:
    return bool(t.float().isfinite().all().item())


#: (kernel, B, T, causal): the two training legs' shapes, each leg's own
#: kernel first; the next two run a kernel at the other leg's shape; then
#: the full-forward sampler (one row of 2048, causal), the scorer's batch
#: (32 rows of leg A's 512) and the checkpoint phase's (8 x 512, causal)
ATTN_CASES = (("flash_attention", 64, 512, False),
              ("fused_attention", 8, 2048, True),
              ("flash_attention", 8, 2048, True),
              ("fused_attention", 64, 512, False),
              ("fused_attention", 1, 2048, True),
              ("flash_attention", 32, 512, False),
              ("fused_attention", 8, 512, True))


def check_attention(torch, tat, dev, rates, cases, H=12, Dh=64):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(3)
    for name, B, T, causal in ATTN_CASES:
        frontier = name == "fused_attention"
        # q/k/v as the strided views of packed (B,T,3,H,Dh) projections,
        # as the train step hands them over; two copies exceed the L2
        packs = [torch.randn((B, T, 3, H, Dh), generator=gen, device=dev)
                 .to(torch.bfloat16) for _ in range(2)]
        views = [tuple(p[:, :, i] for i in range(3)) for p in packs]
        q, k, v = views[0]
        ref, ref_lse = tat.reference_flash_fwd(q.float(), k.float(),
                                               v.float(), causal)
        out, lse = tat.attention_fwd(q, k, v, causal=causal,
                                     frontier=frontier)
        torch.cuda.synchronize()
        ref_abs, _ = tat.reference_flash_fwd(q.float(), k.float(),
                                             v.float().abs(), causal)
        diff = (out.float() - ref).abs()
        atol, rtol = TOL_FLASH_BF16
        ok = bool((diff <= atol + rtol * (ref_abs + ref.abs())).all().item()
                  and torch_isfinite(out))
        err = diff.max().item()
        del ref_abs, diff
        lse_err = (lse - ref_lse).abs().max().item()
        out32, lse32 = tat.attention_fwd(q.float(), k.float(), v.float(),
                                         causal=causal, frontier=frontier)
        e32 = max((out32 - ref).abs().max().item(),
                  (lse32 - ref_lse).abs().max().item())
        if not (ok and lse_err < TOL_FLASH_F32 and e32 < TOL_FLASH_F32):
            fail(f"{name} B={B} T={T} causal={causal}: max err bf16 {err} "
                 f"(tol {TOL_FLASH_BF16}), lse {lse_err}, f32 {e32} (tol "
                 f"{TOL_FLASH_F32})")
        del ref, ref_lse, out32, lse32
        ms = device_ms(torch, [lambda w=w: tat.attention_fwd(
            *w, causal=causal, frontier=frontier) for w in views], reps=5)
        pms = event_ms(torch, lambda: tat.reference_flash_fwd(q, k, v,
                                                                causal), 2)
        dense = [tuple(t.transpose(1, 2).contiguous() for t in w)
                 for w in views]
        lms = device_ms(torch, [lambda d=d: F.scaled_dot_product_attention(
            *d, is_causal=causal) for d in dense], reps=5)
        nbytes = 4 * B * T * H * Dh * 2 + B * H * T * 4
        pairs = T * (T + 1) // 2 if causal else T * T
        ops = 4 * B * H * Dh * pairs            # the work these inputs need
        bound, by = bound_of(nbytes, ops, rates)
        cases.append({"kernel": name, "B": B, "T": T, "H": H, "Dh": Dh,
                      "causal": causal, "max_abs_err": err,
                      "tol": f"{TOL_FLASH_BF16[0]} + {TOL_FLASH_BF16[1]} "
                             "(sum(p|v|)/l + |ref|)",
                      "max_abs_err_f32": e32, "lse_err": lse_err,
                      "tol_f32": TOL_FLASH_F32, "ms": ms, "plain_ms": pms,
                      "library_ms": lms, "bound_ms": bound, "bound_by": by,
                      "bytes": nbytes, "ops": ops})
        print(f"kernel {name} B={B} T={T} H={H} Dh={Dh} causal={causal}: "
              f"max_err bf16={err:.3g} lse={lse_err:.3g} f32={e32:.3g} "
              f"kernel_ms={ms:.5f} plain_ms={pms:.5f} library_ms={lms:.5f} "
              f"bound_ms={bound:.5f} ({by})", flush=True)
        del packs, views, dense, q, k, v, out, lse


def check_layernorm(torch, tln, dev, rates, cases, D=768):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(4)
    for N in LN_ROWS:
        ncopy = copies_for(2 * N * D * 2)
        xs = [torch.randn((N, D), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(ncopy)]
        rs = [torch.randn((N, D), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(ncopy)]
        m = torch.ones((N, 1), device=dev)     # the train step's keep-mask
        s = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
        b = 0.1 * torch.randn((D,), generator=gen, device=dev)
        ry, rh = tln.reference_residual_layernorm(xs[0].float(),
                                                  rs[0].float(), s, b, mask=m)
        y, h = tln.residual_layernorm_fwd(xs[0], rs[0], m, s, b)
        torch.cuda.synchronize()
        oky, ey = within(y, ry, TOL_LN_BF16)
        okh, eh = within(h, rh, TOL_LN_BF16)
        y32, h32 = tln.residual_layernorm_fwd(xs[0].float(), rs[0].float(),
                                              m, s, b)
        e32 = max((y32 - ry).abs().max().item(),
                  (h32 - rh).abs().max().item())
        if not (oky and okh and e32 < TOL_LN_F32):
            fail(f"fused_residual_layernorm N={N}: max err bf16 {max(ey, eh)}"
                 f" (tol {TOL_LN_BF16}), f32 {e32} (tol {TOL_LN_F32})")
        ms = device_ms(torch, [lambda x=x, r=r: tln.residual_layernorm_fwd(
            x, r, m, s, b) for x, r in zip(xs, rs)])
        pms = device_ms(torch, [lambda x=x, r=r: tln.reference_residual_layernorm(
            x, r, s, b, mask=m) for x, r in zip(xs[:2], rs[:2])], reps=5)
        sums = [x + r for x, r in zip(xs, rs)]
        sb, bb = s.to(torch.bfloat16), b.to(torch.bfloat16)
        # F.layer_norm over x + r computed beforehand: one (N, D) read and
        # one write, half the kernel's bytes, so not the same function; the
        # transformer's own two-op seam (registry candidate "unfused") is
        lms = device_ms(torch, [lambda z=z: F.layer_norm(z, (D,), sb, bb)
                                for z in sums])
        ums = device_ms(torch, [lambda x=x, r=r: tln._unfused(x, r, s, b,
                                                              mask=m)
                                for x, r in zip(xs[:2], rs[:2])], reps=5)
        nbytes = 4 * N * D * 2 + N * 4 + 2 * D * 4
        ops = 9 * N * D
        bound, by = bound_of(nbytes, ops, rates)
        cases.append({"kernel": "fused_residual_layernorm", "N": N, "D": D,
                      "max_abs_err": max(ey, eh),
                      "tol": f"{TOL_LN_BF16[0]} + {TOL_LN_BF16[1]} |ref|",
                      "max_abs_err_f32": e32, "tol_f32": TOL_LN_F32,
                      "ms": ms, "plain_ms": pms, "library_ms": lms,
                      "unfused_seam_ms": ums,
                      "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                      "ops": ops})
        print(f"kernel fused_residual_layernorm N={N} D={D}: max_err "
              f"bf16={max(ey, eh):.3g} f32={e32:.3g} kernel_ms={ms:.5f} "
              f"plain_ms={pms:.5f} library_ms={lms:.5f} (layer_norm of a "
              f"precomputed sum) unfused_seam_ms={ums:.5f} "
              f"bound_ms={bound:.5f} ({by})", flush=True)
        del xs, rs, sums


def check_xent(torch, txe, dev, rates, cases, V=32768, D=768):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(5)
    # the tied head as the train step hands it over: tok_embed (V, D) at
    # the init scale, cast to bf16, read as (D, V) through its strides
    embs = [(0.02 * torch.randn((V, D), generator=gen, device=dev))
            .to(torch.bfloat16) for _ in range(2)]
    for N in TRAIN_ROWS:
        hs = [torch.randn((N, D), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2)]
        tg = torch.randint(0, V, (N,), generator=gen, device=dev,
                           dtype=torch.int32)
        w = torch.ones((N,), device=dev)
        head = embs[0].T
        rw, rl = txe.reference_xent_rows(hs[0], head, tg, w)
        wl, lse = txe.xent_fwd(hs[0], head, tg, w)
        torch.cuda.synchronize()
        err = max((wl - rw).abs().max().item(), (lse - rl).abs().max().item())
        wl32, lse32 = txe.xent_fwd(hs[0].float(), head.float(), tg, w)
        e32 = max((wl32 - rw).abs().max().item(),
                  (lse32 - rl).abs().max().item())
        if not (err < TOL_XENT and e32 < TOL_XENT and torch_isfinite(wl)):
            fail(f"blocked_cross_entropy N={N}: max err bf16 {err}, f32 {e32}"
                 f" (tol {TOL_XENT})")
        del rw, rl, wl32, lse32
        ms = device_ms(torch, [lambda h=h, e=e: txe.xent_fwd(h, e.T, tg, w)
                               for h, e in zip(hs, embs)], reps=3)
        pms = event_ms(torch, lambda: txe.reference_xent_rows(hs[0], head, tg,
                                                              w), 2)
        tl = tg.long()
        lms = event_ms(torch, lambda: F.cross_entropy(hs[0] @ head, tl,
                                                      reduction="sum"), 3)
        # the default vocabulary split (one block a SM at most) against two
        # splits, uncounted launches of the same kernel
        splits = txe._splits(hs[0].device, N, -(-V // txe._BV))
        ms2 = device_ms(torch, [lambda h=h, e=e: txe._launch(h, e.T, tg, w,
                                                             n_splits=2)
                                for h, e in zip(hs, embs)], reps=3)
        nbytes = N * D * 2 + D * V * 2 + N * 4 * 4
        ops = 2 * N * V * D
        bound, by = bound_of(nbytes, ops, rates)
        cases.append({"kernel": "blocked_cross_entropy", "N": N, "V": V,
                      "D": D, "max_abs_err": err, "tol": TOL_XENT,
                      "max_abs_err_f32": e32, "tol_f32": TOL_XENT, "ms": ms,
                      "plain_ms": pms, "library_ms": lms, "bound_ms": bound,
                      "bound_by": by, "bytes": nbytes, "ops": ops,
                      "splits": splits, "ms_2_splits": ms2})
        print(f"kernel blocked_cross_entropy N={N} V={V} D={D}: max_err "
              f"bf16={err:.3g} f32={e32:.3g} kernel_ms={ms:.5f} "
              f"({splits} split(s); 2 splits {ms2:.5f}) "
              f"plain_ms={pms:.5f} library_ms={lms:.5f} "
              f"bound_ms={bound:.5f} ({by})", flush=True)
        del hs
    del embs


# ------------------------------------------------------------------ training

def train_leg(torch, ttr, TT, cfg, batch, seq, steps, label, wrappers,
              rates, profile=False):
    """Warm-up then ``steps`` timed train steps of ``cfg`` at ``batch`` x
    ``seq`` through ``TransformerLM.build_train_step``, counts reset just
    before the timed steps; then, with ``profile``, one more step under
    ``torch.profiler``.  Fails on a non-finite loss, a first loss off
    ln(V) or launch counts other than the config implies."""
    import math

    model = ttr.TransformerLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tx = TT.adamw(TT.warmup_cosine(1e-4, 10, 1000), weight_decay=0.01)
    opt = model.init_opt(params, tx)
    step = model.build_train_step(tx)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = []
    for _ in range(2):
        toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                             device="cuda")
        batches.append((toks, torch.roll(toks, -1, dims=1)))
    torch.cuda.reset_peak_memory_stats()
    params, opt, loss = step(params, opt, *batches[0])        # warm-up
    losses = [loss.item()]
    # random init: logits near 0, so the first loss is near ln(V)
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        fail(f"{label}: first loss {losses[0]} far from ln(V)")
    reset_counts(wrappers)
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, *batches[(i + 1) % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = {w.__name__: w.launches for w in wrappers}
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss in {losses}")
    per_step = cfg.n_layers * (2 if cfg.remat else 1)   # remat reruns fwd
    attn = {"flash": "flash_attention", "fused": "fused_attention"}[
        cfg.attention]
    expected = {name: 0 for name in counts}
    expected.update({attn: per_step * steps,
                     "fused_residual_layernorm": per_step * steps,
                     "blocked_cross_entropy": steps})
    if counts != expected:
        fail(f"{label}: launches {counts}, the config implies {expected}")
    p50 = sorted(times)[len(times) // 2]
    tokens = batch * seq
    report = {"batch": batch, "seq": seq, "causal": cfg.causal,
              "remat": cfg.remat, "attention": cfg.attention,
              "steps": steps, "step_s": times, "p50_step_s": p50,
              "tokens_per_s": tokens / p50,
              "mfu": cfg.flops_per_token() * tokens / p50 / rates[1],
              "losses": losses, "launches": counts,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
              "config": str(cfg)}
    if profile:
        report["profile"] = profile_step(torch, step, params, opt,
                                         batches[0])
    print(f"{label}: batch {batch}x{seq} p50_step_ms={p50 * 1e3:.2f} "
          f"tokens_per_s={report['tokens_per_s']:.1f} "
          f"mfu={report['mfu']:.4f} losses={[round(x, 5) for x in losses]} "
          f"launches={counts} peak_mem_gb={report['peak_mem_gb']:.2f}",
          flush=True)
    del params, opt, step, model
    torch.cuda.empty_cache()
    return report


#: symbols of the port's own training kernels, as the profiler names them
PORT_KERNEL_SYMBOLS = ("flash_fwd_kernel", "flash_fwd_f32_kernel",
                       "xent_tiles_kernel", "xent_tiles_f32_kernel",
                       "xent_merge_kernel", "residual_layernorm_kernel")


def kernel_class(name: str) -> str:
    """The layer a device kernel of the train step belongs to."""
    if any(sym in name for sym in PORT_KERNEL_SYMBOLS):
        return "port kernels"
    low = name.lower()
    if "sgemm" in low or "f32f32_f32f32" in low:
        return "f32 GEMM"
    # cuBLAS names its Hopper tensor-core GEMMs nvjet_*
    if "gemm" in low or low.startswith("nvjet"):
        return "tensor-core GEMM"
    return "elementwise, reductions, copies"


def profile_step(torch, step, params, opt, batch):
    """One train step under ``torch.profiler``: device time by kernel name
    and by class (:func:`kernel_class`), and the device's busy share of
    the step's wall time (one stream, so kernel times add up without
    overlap)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, *batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: Counter = Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    if busy_ms <= 0:
        print("profile: no device time in the trace (not measured)",
              flush=True)
        return {"wall_ms": wall * 1e3, "busy_ms": None}
    by_class: Counter = Counter()
    for n, us in by_name.items():
        by_class[kernel_class(n)] += us / 1e3
    top = [{"name": n[:120], "ms": us / 1e3} for n, us in
           by_name.most_common(15)]
    out = {"wall_ms": wall * 1e3, "busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / (wall * 1e3),
           "by_class_ms": dict(by_class), "top": top,
           "by_name_ms": {n: us / 1e3 for n, us in by_name.most_common()}}
    print(f"profile: step wall_ms={wall * 1e3:.2f} device busy_ms="
          f"{busy_ms:.2f} idle_share={out['idle_share']:.4f}", flush=True)
    for c, ms in by_class.most_common():
        print(f"  class {ms:9.3f} ms  {c}", flush=True)
    for t in top:
        print(f"  {t['ms']:9.3f} ms  {t['name']}", flush=True)
    return out


def step_kernels_vs_plain(torch, ttr, tat, tln, txe, base_cfg, label,
                          B=4, T=512):
    """Loss and gradients of one train step through the kernels against the
    same through every plain version (``TrainKernels``), on one state, in
    bf16 and float32; fails outside the tolerances."""
    import dataclasses

    from deeplearning4j_tpu_torch.utils.tree_math import (tree_leaves,
                                                          tree_unflatten)

    plain = ttr.TrainKernels(
        attention=lambda q, k, v, causal: tat.reference_flash_fwd(
            q, k, v, causal)[0],
        residual_layernorm=tln.reference_residual_layernorm,
        xent=txe.reference_xent_sum)
    out = {}
    for dtype, (tol_loss, tol_grad) in ((torch.bfloat16, TOL_STEP_BF16),
                                        (torch.float32, TOL_STEP_F32)):
        cfg = dataclasses.replace(base_cfg, dtype=dtype, remat=False)
        params = ttr.init_params(torch.Generator(device="cuda").manual_seed(7),
                                 cfg, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(8)
        toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                             device="cuda")
        tg = torch.roll(toks, -1, dims=1)
        runs = []
        for kern in (None, plain):
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            loss = ttr.lm_loss_local(tree_unflatten(params, leaves), toks, tg,
                                     cfg, kernels=kern)
            runs.append((loss.item(), torch.autograd.grad(loss, leaves)))
        (lk, gk), (lp, gp) = runs
        loss_err = abs(lk - lp) / abs(lp)
        grad_err = max(((a - b).abs().max() / b.abs().max()).item()
                       for a, b in zip(gk, gp))
        dt = str(dtype).replace("torch.", "")
        out[dt] = {"loss_kernels": lk, "loss_plain": lp,
                   "loss_rel_err": loss_err, "grad_rel_err": grad_err}
        if not (loss_err <= tol_loss and grad_err <= tol_grad):
            fail(f"{label} ({dt}): kernels vs plain loss rel err {loss_err} "
                 f"(tol {tol_loss}), max grad rel err {grad_err} (tol "
                 f"{tol_grad})")
        del params, runs, gk, gp
    print(f"{label}: kernels vs plain, one step at {B}x{T}: {out}", flush=True)
    return out


# ------------------------------------------------------------------ report

def main_path_weights(case, reports, mcfg, legs):
    """Launches of the main-path runs at a measured case's shape.

    Serving (``reports``: the engines, beam search): every step runs 2
    FFN matmuls per layer and the head, at the rows each report lists in
    ``int8_rows`` ({M: steps}: M=1 for prefill, the slots for a decode
    step, slots x (spec_k + 1) for a verify window, the beam width); every
    step in ``paged_steps`` runs one paged attention per layer with the
    config's kv heads (prefill attends over its dense batch-of-1 cache,
    a verify window over a gather).  Forward runs (``legs``: the training
    legs, the full-forward sampler, the scorer): attention launches count
    at their (B, T, causal), LN and xent launches at their B*T rows.
    Cases off the main paths weigh 0: the paged cases at long-context
    lengths and at other kv-head counts than the config's."""
    name = case["kernel"]
    if name in TRAIN_KERNELS:
        if "T" in case:
            return sum(leg["launches"][name] for leg in legs
                       if (leg["batch"], leg["seq"], leg["causal"])
                       == (case["B"], case["T"], case["causal"]))
        return sum(leg["launches"][name] for leg in legs
                   if leg["batch"] * leg["seq"] == case["N"])
    ffn = {(mcfg.d_model, mcfg.d_ff), (mcfg.d_ff, mcfg.d_model)}
    if name == "int8_matmul":
        per_step = (mcfg.n_layers if (case["K"], case["N"]) in ffn
                    else 1 if case["N"] == mcfg.vocab_size else 0)
        return per_step * sum(r["int8_rows"].get(case["M"], 0)
                              for r in reports)
    if case["Kv"] != mcfg.kv_heads or case["lengths"] != "{}-{}".format(
            *ENGINE_LENGTHS):
        return 0
    quant = name == "paged_attention_int8"
    return mcfg.n_layers * sum(r["paged_steps"] for r in reports
                               if (r.get("kv_quant") == "int8") == quant)


def kernel_rows(cases, reports, legs, mcfg, rates):
    """The ``kernels`` line: per kernel, ms / plain_ms / library_ms /
    bound_ms are means over the main-path runs' launches (each measured
    shape weighted by its launches in those runs), and ``shapes`` lists
    every shape measured, with its weight."""
    src = "deeplearning4j_tpu_torch/csrc/"
    jax = "deeplearning4j_tpu/ops/"
    meta = {
        "int8_matmul": (src + "int8_matmul.cu",
                        jax + "pallas/matmul_int8.py:86"),
        "paged_attention": (src + "paged_attention.cu",
                            jax + "pallas/paged_attention.py:197"),
        "paged_attention_int8": (src + "paged_attention.cu",
                                 jax + "pallas/paged_attention.py:258"),
        "flash_attention": (src + "flash_attention.cu",
                            jax + "flash_attention.py:93"),
        "fused_attention": (src + "flash_attention.cu",
                            jax + "pallas/attention.py:102"),
        "fused_residual_layernorm": (src + "residual_layernorm.cu",
                                     jax + "pallas/layernorm.py:74"),
        "blocked_cross_entropy": (src + "blocked_xent.cu",
                                  jax + "pallas/xent.py:97"),
    }
    rows = []
    for kname, (source, replaces) in meta.items():
        kcases = [c for c in cases if c["kernel"] == kname]
        w = [main_path_weights(c, reports, mcfg, legs) for c in kcases]
        if sum(w) <= 0:
            fail(f"{kname}: no measured shape lies on the main path")

        def mean(key):
            return sum(wi * c[key] for wi, c in zip(w, kcases)) / sum(w)

        shapes = [{k: c[k] for k in c if k not in ("kernel", "tol",
                                                     "tol_f32")}
                  | {"main_path_launches": wi} for wi, c in zip(w, kcases)]
        bw, peak = rates
        launches = sum(r["launches"][kname] for r in list(reports) + legs)
        rows.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in kcases),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": ("bytes" if mean("bytes") / bw >= mean("ops") / peak
                         else "operations"),
            "library_ms": mean("library_ms"),
            "launches_expected": sum(w), "shapes": shapes})
    return rows


# ------------------------------------------------------------------ engines

def reset_counts(wrappers):
    for w in wrappers:
        w.launches = 0


def teacher_forced(torch, ttr, tmm, tpa, kv_quant, mcfg, params, dev,
                   quant: bool, B=8, fill=128, steps=64):
    """Kernels vs plain versions on one decode state: fill a paged state
    of B rows with ``fill`` positions through the kernel path, then run
    ``steps`` more positions, each once with the kernels and once (on a
    copy of the state) with the plain versions; compare the logits."""
    ps = 16
    n_slot = -(-mcfg.max_len // ps)
    P = B * n_slot + 1
    if quant:
        pages = kv_quant.init_quantized_paged_cache(mcfg, P, ps, "int8", dev)
        attn, ref_attn = tpa.paged_attention_int8, \
            tpa.reference_paged_attention_int8
    else:
        pages = ttr.init_paged_cache(mcfg, P, ps, dev)
        attn, ref_attn = tpa.paged_attention, tpa.reference_paged_attention
    bt = torch.arange(B * n_slot, device=dev, dtype=torch.int32).reshape(
        B, n_slot)
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, mcfg.vocab_size, (B, fill + steps),
                         generator=gen, device=dev)
    agree = total = 0
    max_err = 0.0
    with torch.no_grad():
        for t in range(fill + steps):
            if t >= fill:
                copy = [{k: v.clone() for k, v in c.items()} for c in pages]
                plain, _ = ttr.decode_step_paged(
                    params, copy, bt, toks[:, t], t, mcfg, attn_fn=ref_attn,
                    int8_fn=tmm.reference_int8_matmul)
            logits, _ = ttr.decode_step_paged(params, pages, bt, toks[:, t],
                                              t, mcfg, attn_fn=attn)
            if t >= fill:
                if not torch.isfinite(logits).all().item():
                    fail("non-finite logits in the teacher-forced step")
                max_err = max(max_err,
                              (logits - plain).abs().max().item())
                agree += int((logits.argmax(-1) == plain.argmax(-1))
                             .sum().item())
                total += B
                del copy
    return agree / total, max_err


def kernels_vs_plain(torch, ttr, tmm, tpa, kv_quant, mcfg, params, quant,
                     label, dev="cuda", **kw):
    """The teacher-forced comparison in the engines' dtype and in float32
    (the same weights); fails the run outside the tolerances."""
    import dataclasses

    out = {}
    for cfg, floor, tol in ((mcfg, TOL_TOP1_BF16, TOL_LOGITS_BF16),
                            (dataclasses.replace(mcfg, dtype=torch.float32),
                             TOL_TOP1, TOL_LOGITS_F32)):
        sp = ttr.cast_for_decode(tmm.quantize_params_for_decode(params, cfg),
                                 cfg)
        top1, err = teacher_forced(torch, ttr, tmm, tpa, kv_quant, cfg, sp,
                                   dev, quant=quant, **kw)
        dt = str(cfg.dtype).replace("torch.", "")
        out[dt] = {"top1": top1, "max_err": err}
        if top1 < floor or not err <= tol:
            fail(f"{label} ({dt}): kernels vs plain top1 {top1} (floor "
                 f"{floor}) / max logit err {err} (tol {tol})")
        del sp
    return out


def make_prompts(rng, n, vocab, lengths=PROMPT_TOKENS, prefix=()):
    """``n`` prompts of ``prefix`` plus random tokens, their count drawn
    from ``lengths`` (inclusive)."""
    return [list(prefix) + rng.integers(0, vocab, int(rng.integers(
        lengths[0], lengths[1] + 1))).tolist() for _ in range(n)]


def run_engine(eng, tmodel, params, scfg, prompts, wrappers, label,
               dev="cuda", max_new=NEW_TOKENS, **engine_kw):
    """Serve ``prompts`` as concurrent greedy requests; returns the engine
    (still running) and the report with the served tokens and the launch
    counts of this run alone (reset after warm-up, read at the end)."""
    mcfg = tmodel.cfg
    engine = eng.InferenceEngine(tmodel, params, cfg=scfg, device=dev,
                                 **engine_kw)
    engine.start()                     # builds/loads the kernels, warms up
    reset_counts(wrappers)             # counts of THIS path only
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new) for p in prompts]
    comps = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in wrappers}
    for c in comps:
        if len(c.tokens) != max_new or c.finish_reason != "length":
            fail(f"{label}: a request ended {c.finish_reason} with "
                 f"{len(c.tokens)} tokens")
        if any(not 0 <= t < mcfg.vocab_size for t in c.tokens):
            fail(f"{label}: token out of range")
    snap = engine.metrics.snapshot()
    timers, counters = snap["timers"], snap["counters"]
    tokens = sum(len(c.tokens) for c in comps)
    # prefill runs prompt[:-1] token by token (M=1) past the positions the
    # prefix cache saved; a decode step runs all slots (M=slots), a verify
    # window slots x (spec_k + 1) rows
    prefill = (sum(len(p) - 1 for p in prompts)
               - int(counters.get("serving.prefix_cached_tokens", 0)))
    steps = int(counters.get("serving.decode.dispatches", 0))
    window = scfg.spec_k + 1 if scfg.speculative else 1
    report = {"requests": len(prompts), "completed": len(comps),
              "prompt_tokens": sum(len(p) for p in prompts),
              "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
              "ttft_p50_s": timers["serving.ttft"]["p50_s"],
              "decode_step_p50_s": timers["serving.decode_step"]["p50_s"],
              "prefill_p50_s": timers["serving.prefill"]["p50_s"],
              "prefill_steps": prefill, "decode_steps": steps,
              "int8_rows": ({1: prefill, scfg.slots * window: steps}
                            if scfg.int8_decode else {}),
              "paged_steps": (steps if scfg.paged and not scfg.speculative
                              and scfg.paged_attention_impl != "gather"
                              else 0),
              "slots": scfg.slots, "kv_quant": scfg.kv_quant,
              "served": [c.tokens for c in comps],
              "launches": counts, "config": str(scfg)}
    if scfg.speculative:
        acc = timers["serving.spec_accept_len"]
        report["spec_accept_len"] = {
            "p50": acc["p50_s"], "mean": acc["mean_s"],
            "windows": acc["count"]}
    if scfg.prefix_cache:
        stats = engine.stats()
        report["prefix"] = {k: stats[k] for k in (
            "prefix_hit_rate", "prefix_hits", "prefix_lookups",
            "prefix_entries")}
        report["prefix"]["cached_tokens"] = int(counters.get(
            "serving.prefix_cached_tokens", 0))
    return engine, report


def engine_line(label, rep) -> str:
    extra = ""
    if "spec_accept_len" in rep:
        extra += f" spec_accept_len={rep['spec_accept_len']}"
    if "prefix" in rep:
        extra += f" prefix={rep['prefix']}"
    return (f"{label}: {rep['completed']}/{rep['requests']} requests, "
            f"tokens/s={rep['tokens_per_s']:.1f} "
            f"ttft_p50_s={rep['ttft_p50_s']:.4f} "
            f"decode_step_p50_s={rep['decode_step_p50_s']:.5f} "
            f"launches={rep['launches']}{extra}")


def token_agreement(got, want) -> dict:
    """Served greedy tokens of two engines on the same prompts: requests
    identical, and the share of tokens before each request's first
    difference (after it the two continue different sequences)."""
    same = sum(g == w for g, w in zip(got, want))
    lead = 0
    for g, w in zip(got, want):
        n = 0
        while n < min(len(g), len(w)) and g[n] == w[n]:
            n += 1
        lead += n
    total = sum(len(w) for w in want)
    return {"identical_requests": same, "requests": len(want),
            "tokens_before_first_difference": lead / total}


def window_vs_steps(torch, ttr, tmm, tpa, mcfg, params, dev="cuda", B=8,
                    fill=128, steps=64, W=4):
    """Teacher-forced, the speculative verify path against the plain
    sequential path, in the engines' dtype and in float32 (the same
    weights): fill a paged state of B rows to ``fill`` positions through
    the kernel step, then for ``steps`` more positions, a window of W at a
    time, run ``decode_window_paged`` with the kernels (``int8_matmul`` at
    M = B*W) on the state and W ``decode_step_paged`` calls through every
    plain version on a copy; compare the logits.  Held to the
    teacher-forced rule of the engines (``kernels_vs_plain``)."""
    import dataclasses

    out = {}
    for cfg, floor, tol in ((mcfg, TOL_TOP1_BF16, TOL_LOGITS_BF16),
                            (dataclasses.replace(mcfg, dtype=torch.float32),
                             TOL_TOP1, TOL_LOGITS_F32)):
        sp = ttr.cast_for_decode(tmm.quantize_params_for_decode(params, cfg),
                                 cfg)
        ps = 16
        n_slot = -(-cfg.max_len // ps)
        pages = ttr.init_paged_cache(cfg, B * n_slot + 1, ps, dev)
        bt = torch.arange(B * n_slot, device=dev,
                          dtype=torch.int32).reshape(B, n_slot)
        gen = torch.Generator(device=dev).manual_seed(6)
        toks = torch.randint(0, cfg.vocab_size, (B, fill + steps),
                             generator=gen, device=dev)
        agree = total = 0
        max_err = 0.0
        with torch.no_grad():
            for t in range(fill):
                ttr.decode_step_paged(sp, pages, bt, toks[:, t], t, cfg,
                                      attn_fn=tpa.paged_attention)
            for t0 in range(fill, fill + steps, W):
                copy = [{k: v.clone() for k, v in c.items()} for c in pages]
                win, _ = ttr.decode_window_paged(sp, pages, bt,
                                                 toks[:, t0:t0 + W], t0, cfg)
                if not torch.isfinite(win).all().item():
                    fail("non-finite logits in the verify window")
                for w in range(W):
                    plain, _ = ttr.decode_step_paged(
                        sp, copy, bt, toks[:, t0 + w], t0 + w, cfg,
                        attn_fn=tpa.reference_paged_attention,
                        int8_fn=tmm.reference_int8_matmul)
                    max_err = max(max_err,
                                  (win[:, w] - plain).abs().max().item())
                    agree += int((win[:, w].argmax(-1) == plain.argmax(-1))
                                 .sum().item())
                    total += B
                del copy
        dt = str(cfg.dtype).replace("torch.", "")
        out[dt] = {"top1": agree / total, "max_err": max_err}
        if agree / total < floor or not max_err <= tol:
            fail(f"verify window vs steps ({dt}): top1 {agree / total} "
                 f"(floor {floor}) / max logit err {max_err} (tol {tol})")
        del sp, pages
    return out


#: the prefix-cache phase: 16 requests share a 128-token system prompt,
#: each with a suffix of 16-128 tokens, 16 new tokens each
PREFIX_SYSTEM, PREFIX_SUFFIX, PREFIX_NEW = 128, (16, 128), 16


def run_prefix(eng, tmodel, params, rng, wrappers, dev="cuda", n_req=16,
               slots=8, page_size=16, system=PREFIX_SYSTEM,
               suffix=PREFIX_SUFFIX, max_new=PREFIX_NEW):
    """The prefix-cache engine on float and on int8 pages against the same
    engine with ``prefix_cache=False``, on the same prompts.  Float pages:
    the hit rate is positive and the tokens are equal (a hit skips
    positions whose K/V it aliases, the same bytes the prefill would
    write).  int8 pages: the hit rate is positive, and the two engines'
    logits are held to the teacher-forced rule of the engines
    (:func:`prefix_teacher_forced`); their served tokens are reported,
    not held equal: a hit's suffix prefill attends over the dequantized
    prefix pages where the uncached prefill attends over the unquantized
    K/V, in the JAX package as here (whose own int8 prefix test holds
    agreement, not equality), so a near tie can flip and the two
    continue different sequences from there."""
    vocab = tmodel.cfg.vocab_size
    head = rng.integers(0, vocab, system).tolist()
    prompts = make_prompts(rng, n_req, vocab, suffix, prefix=head)
    out = {}
    for label, extra in (("float", dict(paged_attention_impl="pallas")),
                         ("int8", dict(kv_quant="int8",
                                       paged_attention_impl="pallas_int8"))):
        runs = {}
        for cache in (True, False):
            scfg = eng.ServingConfig(slots=slots, paged=True,
                                     page_size=page_size, int8_decode=True,
                                     prefix_cache=cache, **extra)
            engine, rep = run_engine(eng, tmodel, params, scfg, prompts,
                                     wrappers, f"prefix {label}", dev=dev,
                                     max_new=max_new)
            engine.stop()
            del engine
            runs[cache] = rep
        hit = runs[True]["prefix"]["prefix_hit_rate"]
        agree = token_agreement(runs[True]["served"], runs[False]["served"])
        if not hit > 0:
            fail(f"prefix {label}: hit rate {hit}")
        if label == "float" and runs[True]["served"] != runs[False]["served"]:
            fail(f"prefix float: tokens differ from prefix_cache=False: "
                 f"{agree}")
        print(engine_line(f"prefix {label} (cache)", runs[True])
              + f" agreement with prefix_cache=False: {agree}", flush=True)
        print(engine_line(f"prefix {label} (no cache)", runs[False]),
              flush=True)
        out[label] = {"cache": runs[True], "no_cache": runs[False],
                      "agreement": agree}
        if label == "int8":
            tf = prefix_teacher_forced(eng, tmodel, params, prompts,
                                       runs[False]["served"], extra, dev=dev,
                                       slots=slots, page_size=page_size)
            out[label]["teacher_forced"] = tf
            print(f"prefix int8 teacher-forced, cache vs no cache: {tf}",
                  flush=True)
            if (tf["top1"] < TOL_TOP1_BF16
                    or not tf["max_err"] <= TOL_LOGITS_BF16
                    or tf["hits"] != n_req - 1):
                fail(f"prefix int8: teacher-forced {tf} (top1 floor "
                     f"{TOL_TOP1_BF16}, logit tol {TOL_LOGITS_BF16}, "
                     f"{n_req - 1} hits)")
    return out


def prefix_teacher_forced(eng, tmodel, params, prompts, served, extra,
                          dev="cuda", slots=8, page_size=16):
    """Teacher-forced, the prefix-cache engine against the same engine
    with ``prefix_cache=False``: each prompt goes through the engine's own
    admission, one at a time (the cache aliases the shared prefix pages
    and its prefill attends their dequantized content), then the uncached
    engine's served tokens are fed one at a time through the engine's
    paged step (its params, pages and paged-attention kernel) on the
    request's block-table row.  Returns the top-1 agreement and the
    largest difference of the two engines' logits over every fed
    position, and the cached engine's prefix hits."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as ttr

    mcfg = tmodel.cfg
    logits, hits = {}, 0
    for cache in (True, False):
        scfg = eng.ServingConfig(slots=slots, paged=True,
                                 page_size=page_size, int8_decode=True,
                                 prefix_cache=cache, **extra)
        engine = eng.InferenceEngine(tmodel, params, cfg=scfg, device=dev)
        st, rows = engine._state, []
        with torch.no_grad():
            for prompt, cont in zip(prompts, served):
                engine.submit(prompt, len(cont))
                engine._admit(engine._queue.take(1))
                slot, = engine._slots
                bt = st["bt"][slot:slot + 1]
                fed = torch.tensor(prompt[-1:] + cont[:-1], device=dev)
                for j in range(len(cont)):
                    out, _ = ttr.decode_step_paged(
                        engine._params, st["pages"], bt, fed[j:j + 1],
                        len(prompt) - 1 + j, mcfg, attn_fn=engine._attn_fn)
                    rows.append(out[0])
                engine._evict(slot, "length", time.monotonic())
        logits[cache] = torch.stack(rows)
        if cache:
            hits = engine.stats()["prefix_hits"]
        del engine, st
    a, b = logits[True], logits[False]
    if not torch.isfinite(a).all().item():
        fail("prefix int8: non-finite logits in the teacher-forced run")
    return {"top1": (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
            "max_err": (a - b).abs().max().item(), "positions": a.shape[0],
            "hits": hits}


def run_sample(torch, ttr, wrappers, dev="cuda", cfg=None, prime_len=16,
               length=8):
    """``TransformerLM.sample(kv_cache=False)`` (a full forward over the
    ``(1, max_len)`` buffer a token, through the attention and fused LN
    kernels) against ``kv_cache=True``, greedy, on the default causal
    config with ``attention="fused", fused_ln=True``: in bf16 (the main
    path: its launches, times and whether the tokens agree) and in
    float32, where the two paths differ by summation order only and the
    tokens must be equal."""
    import dataclasses

    cfg = cfg or ttr.TransformerConfig(attention="fused", fused_ln=True)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = ttr.TransformerLM(c, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        prime = torch.randint(0, c.vocab_size, (prime_len,), device=dev,
                              generator=torch.Generator(device=dev)
                              .manual_seed(1)).tolist()
        reset_counts(wrappers)
        t0 = time.perf_counter()
        full = model.sample(params, prime, length, temperature=0.0)
        t_full = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in wrappers}
        t0 = time.perf_counter()
        cached = model.sample(params, prime, length, temperature=0.0,
                              kv_cache=True)
        t_cached = time.perf_counter() - t0
        dt = str(dtype).replace("torch.", "")
        if len(full) != prime_len + length or full[:prime_len] != prime \
                or any(not 0 <= t < c.vocab_size for t in full):
            fail(f"sample({dt}): bad sequence {full}")
        if dtype == torch.float32 and full != cached:
            fail(f"sample(kv_cache=False) {full[prime_len:]} != "
                 f"kv_cache=True {cached[prime_len:]} in float32")
        out[dt] = {"batch": 1, "seq": c.max_len, "causal": True,
                   "tokens_full": full[prime_len:],
                   "tokens_cached": cached[prime_len:],
                   "equal": full == cached, "full_s": t_full,
                   "cached_s": t_cached, "launches": counts}
        print(f"sample {dt}: kv_cache=False {t_full:.3f} s, kv_cache=True "
              f"{t_cached:.3f} s for {length} tokens, tokens equal: "
              f"{full == cached}, launches={counts}", flush=True)
        del model, params
    expected = cfg.n_layers * length
    got = out["bfloat16"]["launches"]
    if dev == "cuda" and (got["fused_attention"] != expected
                          or got["fused_residual_layernorm"] != expected):
        fail(f"sample(kv_cache=False): launches {got}, expected {expected} "
             "fused_attention and fused_residual_layernorm")
    return out


def run_beam(torch, ttr, tmm, tmodel, params, wrappers, width=4, length=8,
             prime_len=16, dev="cuda"):
    """``beam_search`` at width 4 over the int8 serving tree (FFN and head
    through ``int8_matmul`` at M = 4); its parity is held on the CPU."""
    import math

    cfg = tmodel.cfg
    sp = ttr.cast_for_decode(tmm.quantize_params_for_decode(params, cfg),
                             cfg)
    prime = torch.randint(0, cfg.vocab_size, (prime_len,), device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(2)).tolist()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    seq, score = tmodel.beam_search(sp, prime, length, beam_width=width)
    wall = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in wrappers}
    if (len(seq) != prime_len + length or seq[:prime_len] != prime
            or any(not 0 <= t < cfg.vocab_size for t in seq)
            or not math.isfinite(score)):
        fail(f"beam_search: sequence {seq} score {score}")
    steps = prime_len - 1 + length
    if dev == "cuda" and counts["int8_matmul"] != steps * (
            2 * cfg.n_layers + 1):
        fail(f"beam_search: launches {counts} for {steps} steps")
    print(f"beam_search width={width}: {length} tokens in {wall:.3f} s, "
          f"score={score:.4f}, launches={counts}", flush=True)
    return {"width": width, "tokens": seq[prime_len:], "score": score,
            "wall_s": wall, "int8_rows": {width: steps}, "paged_steps": 0,
            "launches": counts}


def run_scorer(torch, ttr, serving, cfg, wrappers, rng, rows=32,
               dev="cuda"):
    """``BatchScorer`` over ``forward_local`` at ``cfg`` behind
    ``ModelServer``: ``rows`` concurrent rows of ``cfg.max_len`` token ids
    through ``ServingClient.score`` (one coalesced batch), each answered
    with the log-probability of its own tokens; the rows must equal
    direct ``forward_local`` calls of one row within the attention
    tolerance (0.05)."""
    import numpy as np

    model = ttr.TransformerLM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    def logp(toks):
        logits = ttr.forward_local(params, toks, cfg)
        return torch.log_softmax(logits, -1).gather(
            -1, toks[..., None])[..., 0]

    def fn(xs):
        return logp(torch.as_tensor(xs, device=dev).long())

    data = rng.integers(0, cfg.vocab_size, (rows, cfg.max_len))
    scorer = serving.BatchScorer(fn, max_batch=rows, max_batch_delay_ms=200)
    with scorer, serving.ModelServer(scorer=scorer) as server:
        client = serving.ServingClient(port=server.port, timeout_s=600)
        client.score(data[:1])                     # warm-up, one row
        before = scorer.metrics.snapshot()["timers"]["serving.score_batch"]
        reset_counts(wrappers)
        t0 = time.perf_counter()
        served = np.asarray(client.score(data), np.float32)
        wall = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in wrappers}
        after = scorer.metrics.snapshot()["timers"]["serving.score_batch"]
    batches = after["count"] - before["count"]
    if batches != 1:
        fail(f"scorer: {rows} rows ran in {batches} batches, not one")
    with torch.no_grad():
        direct = np.stack([logp(torch.as_tensor(r[None], device=dev))[0]
                           .float().cpu().numpy() for r in data])
    err = float(np.abs(served - direct).max())
    if not (served.shape == direct.shape and np.isfinite(served).all()
            and err <= TOL_SCORE):
        fail(f"scorer: rows vs direct forward_local max err {err} "
             f"(tol {TOL_SCORE})")
    batch_s = after["total_s"] - before["total_s"]
    print(f"scorer: {rows} rows x {cfg.max_len} over HTTP in {wall:.3f} s "
          f"(batch {batch_s:.3f} s), max err vs direct calls "
          f"{err:.3g} (tol {TOL_SCORE}), launches={counts}", flush=True)
    del model, params
    return {"batch": rows, "seq": cfg.max_len, "causal": cfg.causal,
            "rows_per_s": rows / wall, "wall_s": wall,
            "batch_s": batch_s, "max_abs_err": err, "tol": TOL_SCORE,
            "launches": counts}


#: the checkpoint phase: the default causal config at 8 x 512, 8 steps under
#: the supervisor (a checkpoint every 2, keep 2), then 2 more steps
CKPT_BATCH, CKPT_SEQ, CKPT_STEPS, CKPT_MORE = 8, 512, 8, 2
#: its three faults: a bit flipped in the step-4 save, a transient failure
#: of step 5's dispatch, a data-pipeline failure at batch 7
CKPT_FAULTS = (("checkpoint.write", 4, "bitflip"), ("train.step", 5, None),
               ("data.next", 7, None))
#: the chaos run against the fault-free run when the determinism probe
#: finds that one step repeated from one state is not bitwise equal: the
#: train step's bf16 tolerance (TOL_STEP_BF16) on every step's loss, and
#: on the final parameters (max |diff| / max |value| over each leaf)
TOL_CHAOS = TOL_STEP_BF16
#: the reload phase's requests: prompt lengths and new tokens
RELOAD_PROMPTS, RELOAD_NEW = (16, 32), 48


def determinism_probe(torch, ttr, tat, tln, txe, make_trainer, params, batch,
                      cfg, dev="cuda"):
    """One train step three times from one state — twice with the host
    waiting on each, once fed by ``prefetch_to_device`` (its copy stream
    busy beside the step) and queued behind the second — loss, parameters
    and optimizer state bitwise?  To name what differs: the loss's forward
    and every gradient leaf twice, and the three training kernels'
    forwards twice at this phase's shapes."""
    from deeplearning4j_tpu_torch.datasets import prefetch_to_device
    from deeplearning4j_tpu_torch.parallel import TrainState
    from deeplearning4j_tpu_torch.parallel.checkpoint import _walk
    from deeplearning4j_tpu_torch.parallel.trainer import make_key
    from deeplearning4j_tpu_torch.utils.tree_math import (tree_leaves,
                                                          tree_unflatten)

    trainer = make_trainer()
    base = trainer.init_state(params, key=0)
    runs, lazies = [], []
    feeds = [batch, batch, next(iter(prefetch_to_device([batch], device=dev)))]
    for i, b in enumerate(feeds):
        st = TrainState(base.params, base.tstate, 0, make_key(0))
        st, lazy = trainer.step(st, *b)
        lazies.append(lazy)
        runs.append((tree_leaves(st.params), tree_leaves(st.tstate)))
        if i < 1:
            lazy.value()
    losses_3 = [float(lz) for lz in lazies]
    names = [k for k, _ in _walk(params)]
    diff_steps = sorted({n for r in runs[1:] for n, a, b in zip(
        names + [f"tstate{i}" for i in range(len(runs[0][1]))],
        runs[0][0] + runs[0][1], r[0] + r[1]) if not torch.equal(a, b)})
    step_bitwise = len(set(losses_3)) == 1 and not diff_steps
    l0, l1 = losses_3[:2]
    del runs
    x, y = (torch.as_tensor(a, device=dev) for a in batch)
    grads, losses = [], []
    for _ in range(2):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = ttr.lm_loss_local(tree_unflatten(params, leaves), x, y, cfg)
        grads.append(torch.autograd.grad(loss, leaves))
        losses.append(loss.item())
    differing = [n for n, a, b in zip(names, *grads) if not torch.equal(a, b)]
    del grads
    gen = torch.Generator(device=dev).manual_seed(12)
    B, T, D = batch[0].shape[0], batch[0].shape[1], cfg.d_model
    H, Dh, N = cfg.n_heads, cfg.head_dim, B * T
    qkv = torch.randn((B, T, 3, H, Dh), generator=gen, device=dev).to(
        cfg.dtype)
    xr = [torch.randn((N, D), generator=gen, device=dev).to(cfg.dtype)
          for _ in range(2)]
    m = torch.ones((N, 1), device=dev)
    s, b = torch.ones((D,), device=dev), torch.zeros((D,), device=dev)
    head = params["tok_embed"].to(cfg.dtype).T
    tg = torch.as_tensor(batch[1], device=dev).reshape(-1).to(torch.int32)
    w = torch.ones((N,), device=dev)
    calls = {
        "fused_attention": lambda: tat.attention_fwd(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=True,
            frontier=True),
        "fused_residual_layernorm": lambda: tln.residual_layernorm_fwd(
            xr[0], xr[1], m, s, b),
        "blocked_cross_entropy": lambda: txe.xent_fwd(xr[0], head, tg, w),
    }
    kernels = {}
    for name, fn in calls.items():
        a, b2 = fn(), fn()
        kernels[name] = all(torch.equal(u, v) for u, v in zip(a, b2))
    out = {"step_bitwise": step_bitwise, "step_losses": losses_3,
           "step_leaves_differing": diff_steps,
           "loss_forward_bitwise": losses[0] == losses[1],
           "grad_leaves_differing": differing,
           "kernel_forward_bitwise": kernels}
    print(f"determinism probe: one step three times from one state "
          f"bitwise={step_bitwise} (losses {losses_3}, leaves differing "
          f"{diff_steps[:6]}); loss forward bitwise="
          f"{out['loss_forward_bitwise']}; gradient leaves differing: "
          f"{len(differing)} of {len(names)} {differing[:6]}; kernel "
          f"forwards bitwise: {kernels}", flush=True)
    return out


def _serve_wave(client, prompts, new, pool):
    """Greedy requests over HTTP, concurrently; the answers in order."""
    futs = [pool.submit(client.generate, p, max_new_tokens=new)
            for p in prompts]
    return [f.result(timeout=900) for f in futs]


def _engine_deltas(engine, before):
    """Prefill tokens and decode dispatches since the ``before`` snapshot
    of the engine's registry."""
    now = engine.metrics.snapshot()["counters"]
    return {k: int(now.get(k, 0) - before.get(k, 0)) for k in (
        "serving.decode.dispatches", "serving.admitted", "serving.tokens")}


def run_checkpoints(torch, ttr, TT, tmm, tat, tln, txe, eng, wrappers, rng,
                    dev="cuda", cfg=None, batch=CKPT_BATCH, seq=CKPT_SEQ,
                    expect_launches=True):
    """Checkpoints, the supervised trainer and hot reload on ``cfg`` (the
    default causal config with ``attention="fused", fused_ln=True`` and
    blocked xent by default), in a temporary directory removed at the end:

    1. the determinism probe; a fault-free run of ``CKPT_STEPS`` steps at
       ``batch`` x ``seq`` (p50 step time); the same run under
       ``TrainingSupervisor`` with a ``CheckpointManager(keep=2)``, a
       checkpoint every 2 steps and the three ``CKPT_FAULTS``, held to the
       fault-free run bitwise (or within ``TOL_CHAOS``, as the probe
       decides); its retries, corruption detected, goodput, save and
       restore seconds, and the launches of kernels #2-#4;
    2. an ``InferenceEngine(checkpoint=dir)`` (8 slots, paged, int8
       decode, the paged kernel) behind ``ModelServer``, restoring the
       newest valid step, serving 8 greedy requests over HTTP;
    3. two more steps publishing step 10; 8 more requests, and while they
       decode, ``ServingClient.reload()``; 8 requests after it.  The
       in-flight ones must carry generation 0 / step 8 and equal the first
       wave's tokens, the later ones generation 1 / step 10 and equal a
       fresh engine's on step 10 (or, failing that, agree teacher-forced
       with step 10's serving tree: top-1 >= TOL_TOP1_BF16)."""
    import concurrent.futures as cf
    import math
    import shutil
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch import observability as tobs
    from deeplearning4j_tpu_torch.parallel import (CheckpointManager,
                                                   DataParallelTrainer)
    from deeplearning4j_tpu_torch.parallel.checkpoint import _walk
    from deeplearning4j_tpu_torch.resilience import (FaultSpec, RetryPolicy,
                                                     TrainingSupervisor,
                                                     inject_faults)
    from deeplearning4j_tpu_torch.serving import ModelServer, ServingClient
    from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves

    cfg = cfg or ttr.TransformerConfig(attention="fused", fused_ln=True,
                                       xent_impl="blocked")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt-"))
    old_dump = tobs.FLIGHTREC.dump_dir
    tobs.FLIGHTREC.dump_dir = work / "flightrec"
    pool = cf.ThreadPoolExecutor(max_workers=8)
    try:
        model = ttr.TransformerLM(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        data = []
        for _ in range(CKPT_STEPS + CKPT_MORE):
            toks = rng.integers(0, cfg.vocab_size, (batch, seq))
            data.append((toks, np.roll(toks, -1, axis=1)))

        def make_trainer():
            return DataParallelTrainer(
                lambda p, x, y, g: ttr.lm_loss_local(p, x, y, cfg),
                TT.adamw(TT.warmup_cosine(1e-3, 2, 1000), weight_decay=0.01),
                device=dev)

        probe = determinism_probe(torch, ttr, tat, tln, txe, make_trainer,
                                  params, data[0], cfg, dev)
        bitwise = probe["step_bitwise"]

        # ---- fault-free run: one resolve a step, for the step times
        tobs.METRICS.reset()
        ref_tr = make_trainer()
        ref, ref_losses = ref_tr.fit(ref_tr.init_state(params, key=0),
                                     data[:CKPT_STEPS], async_dispatch=False)
        step_p50 = tobs.METRICS.snapshot()["timers"]["train_step.execute"][
            "p50_s"]
        if not all(math.isfinite(v) for v in ref_losses) or abs(
                ref_losses[0] - math.log(cfg.vocab_size)) > 0.5:
            fail(f"checkpoint phase: fault-free losses {ref_losses}")
        # ---- the hot loop: dispatches between fences read nothing back
        # (device batches from prefetch_to_device; the ring read after)
        hot = ref_tr.init_state(params, key=0)
        from deeplearning4j_tpu_torch.datasets import prefetch_to_device
        batches = list(prefetch_to_device(data[:3], device=dev))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for x, y in batches:
                hot, _ = ref_tr.step(hot, x, y)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        hot_losses = ref_tr._resolve_pending()
        if not all(abs(a - b) <= (0 if bitwise else TOL_CHAOS[0] * abs(b))
                   for a, b in zip(hot_losses, ref_losses[:3])):
            fail(f"hot loop under sync-debug mode: losses {hot_losses}, the "
                 f"fault-free run's {ref_losses[:3]}")
        print("hot loop: 3 train steps dispatched under torch.cuda."
              "set_sync_debug_mode('error'), no host sync; losses "
              f"{hot_losses} (fault-free run: {ref_losses[:3]})", flush=True)
        del ref_tr, hot, batches

        # ---- the supervised chaos run
        tobs.METRICS.reset()
        mgr = CheckpointManager(work / "ckpt", keep=2)
        reset_counts(wrappers)
        t0 = time.perf_counter()
        faults = [FaultSpec(site, at_step=at, **({"kind": k} if k else {}))
                  for site, at, k in CKPT_FAULTS]
        with inject_faults(*faults, seed=11):
            sup = TrainingSupervisor(mgr, RetryPolicy(max_attempts=4,
                                                      backoff_base_s=0.01))
            state, losses = sup.fit(make_trainer(), params,
                                    data[:CKPT_STEPS], checkpoint_every=2,
                                    key=0)
        chaos_s = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        snap = tobs.METRICS.snapshot()
        counters, timers = snap["counters"], snap["timers"]
        dispatched = int(counters["train_step.iterations"])
        if state.step != CKPT_STEPS or mgr.latest_valid_step() != CKPT_STEPS:
            fail(f"chaos run ended at step {state.step}, newest valid "
                 f"checkpoint {mgr.latest_valid_step()}")
        want_losses = ref_losses[-len(losses):]
        pairs = list(zip(tree_leaves(state.params) + tree_leaves(state.tstate),
                         tree_leaves(ref.params) + tree_leaves(ref.tstate)))
        if bitwise:
            same = losses == want_losses and all(torch.equal(a, b)
                                                 for a, b in pairs)
            if not same:
                names = [k for k, _ in _walk(state.params)]
                differ = [n for n, (a, b) in zip(
                    names + ["tstate"] * len(pairs), pairs)
                    if not torch.equal(a, b)]
                fail(f"chaos run is not bitwise equal to the fault-free run, "
                     f"though one step repeated from one state is: losses "
                     f"{losses} vs {want_losses}, leaves differing {differ}")
            loss_err = param_err = 0.0
        else:
            loss_err = max(abs(a - b) / abs(b) for a, b in
                           zip(losses, want_losses))
            param_err = max(((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp_min(1e-30)).item()
                            for a, b in pairs[:len(tree_leaves(ref.params))])
            if not (loss_err <= TOL_CHAOS[0] and param_err <= TOL_CHAOS[1]):
                fail(f"chaos run vs fault-free: loss rel err {loss_err} (tol "
                     f"{TOL_CHAOS[0]}), param rel err {param_err} (tol "
                     f"{TOL_CHAOS[1]})")
        del pairs, ref
        gp = sup.report.goodput
        if not (abs(gp["accounted_seconds"] - gp["wall_seconds"]) <= 1e-9
                and counters.get("checkpoint.corrupt_detected", 0) >= 1
                and sup.report.retries >= 1):
            fail(f"chaos run: goodput {gp}, counters {counters}, report "
                 f"{sup.report}")
        per_step = cfg.n_layers * (2 if cfg.remat else 1)
        expected = {name: 0 for name in launches}
        expected.update({"fused_attention": per_step * dispatched,
                         "fused_residual_layernorm": per_step * dispatched,
                         "blocked_cross_entropy": dispatched})
        if expect_launches and launches != expected:
            fail(f"chaos run: launches {launches}, the config implies "
                 f"{expected}")
        save, restore = timers["checkpoint.save"], timers["checkpoint.restore"]
        ckpt_bytes = sum(p.stat().st_size for p in
                         (work / "ckpt" / f"ckpt_{CKPT_STEPS:010d}").iterdir())
        train = {
            "batch": batch, "seq": seq, "causal": cfg.causal,
            "steps": CKPT_STEPS, "dispatched": dispatched,
            "determinism": probe, "held": "bitwise" if bitwise else
            f"tolerance {TOL_CHAOS}", "loss_rel_err": loss_err,
            "param_rel_err": param_err, "losses": losses,
            "fault_free_losses": ref_losses, "p50_step_s": step_p50,
            "chaos_wall_s": chaos_s, "retries": sup.report.retries,
            "resumed_from": sup.report.resumed_from,
            "corrupt_detected": counters.get("checkpoint.corrupt_detected"),
            "goodput": {k: gp[k] for k in ("wall_seconds",
                                           "accounted_seconds", "fraction",
                                           "seconds", "states")},
            "checkpoint_bytes": ckpt_bytes, "saves": save["count"],
            "save_s_mean": save["mean_s"], "restores": restore["count"],
            "restore_s_mean": restore["mean_s"],
            "verifications": counters.get("checkpoint.verifications"),
            "launches": launches}
        print(f"checkpoints: supervised {CKPT_STEPS} steps at {batch}x{seq} "
              f"with {len(CKPT_FAULTS)} faults in {chaos_s:.2f} s "
              f"({dispatched} steps dispatched), held {train['held']} "
              f"(loss rel err {loss_err:.3g}, param rel err {param_err:.3g}); "
              f"retries={sup.report.retries} resumed_from="
              f"{sup.report.resumed_from} checkpoint.corrupt_detected="
              f"{train['corrupt_detected']}; p50 step {step_p50 * 1e3:.2f} ms; "
              f"{save['count']} saves of {ckpt_bytes / 1e9:.3f} GB, mean "
              f"{save['mean_s']:.3f} s; {restore['count']} restores, mean "
              f"{restore['mean_s']:.3f} s; goodput fraction "
              f"{gp['fraction']:.4f}, accounted {gp['accounted_seconds']:.6f}"
              f" s == wall {gp['wall_seconds']:.6f} s, seconds "
              f"{ {k: round(v, 3) for k, v in gp['seconds'].items()} }; "
              f"launches={launches}", flush=True)

        # ---- serve from the checkpoint
        scfg = eng.ServingConfig(slots=8, paged=True, page_size=16,
                                 int8_decode=True,
                                 paged_attention_impl="pallas")
        t0 = time.perf_counter()
        engine = eng.InferenceEngine(model, checkpoint=str(work / "ckpt"),
                                     cfg=scfg, device=dev)
        open_s = time.perf_counter() - t0
        if engine.stats()["loaded_step"] != CKPT_STEPS:
            fail(f"engine restored step {engine.stats()['loaded_step']}")
        prompts = make_prompts(rng, 8, cfg.vocab_size, RELOAD_PROMPTS)
        engine.start()
        server = ModelServer(engine, request_timeout_s=900).start()
        client = ServingClient(port=server.port, timeout_s=900)
        try:
            before = dict(engine.metrics.snapshot()["counters"])
            reset_counts(wrappers)
            t0 = time.perf_counter()
            wave0 = _serve_wave(client, prompts, RELOAD_NEW, pool)
            serve_s = time.perf_counter() - t0
            serve_launches = {w.__name__: w.launches for w in wrappers}
            d0 = _engine_deltas(engine, before)
            stamps0 = {(a["generation"], a["loaded_step"]) for a in wave0}
            if stamps0 != {(0, CKPT_STEPS)} or any(
                    len(a["tokens"]) != RELOAD_NEW for a in wave0):
                fail(f"served from the checkpoint: stamps {stamps0}")

            # ---- two more steps publish step 10, then the hot reload
            reset_counts(wrappers)
            tobs.METRICS.reset()
            more_tr = make_trainer()
            state, more_losses = more_tr.fit(state, data,
                                             checkpoint_manager=mgr,
                                             checkpoint_every=2, resume=False)
            more_launches = {w.__name__: w.launches for w in wrappers}
            final = CKPT_STEPS + CKPT_MORE
            if state.step != final or mgr.latest_valid_step() != final:
                fail(f"two more steps ended at {state.step}, newest valid "
                     f"{mgr.latest_valid_step()}")
            more_snap = tobs.METRICS.snapshot()
            before = dict(engine.metrics.snapshot()["counters"])
            admitted0 = engine.stats()["admitted"]
            reset_counts(wrappers)
            futs = [pool.submit(client.generate, p, max_new_tokens=RELOAD_NEW)
                    for p in prompts]
            deadline = time.monotonic() + 300
            while engine.stats()["admitted"] < admitted0 + len(prompts):
                if time.monotonic() > deadline:
                    fail("the reload wave was not admitted")
                time.sleep(0.002)
            t0 = time.perf_counter()
            got_step = client.reload()
            reload_s = time.perf_counter() - t0
            staged = engine.stats()["reload_staged"]
            wave2 = _serve_wave(client, prompts, RELOAD_NEW, pool)
            wave1 = [f.result(timeout=900) for f in futs]
            reload_launches = {w.__name__: w.launches for w in wrappers}
            d1 = _engine_deltas(engine, before)
            stats = engine.stats()
        finally:
            server.stop()
            engine.stop()
        s1 = {(a["generation"], a["loaded_step"]) for a in wave1}
        s2 = {(a["generation"], a["loaded_step"]) for a in wave2}
        if got_step != final or s1 != {(0, CKPT_STEPS)} or \
                s2 != {(1, final)} or stats["generation"] != 1:
            fail(f"reload: step {got_step}, in-flight stamps {s1}, later "
                 f"stamps {s2}, engine {stats}")
        old_equal = [a["tokens"] for a in wave1] == [a["tokens"]
                                                     for a in wave0]
        if not old_equal:
            fail("in-flight completions under step 8 differ from the first "
                 "wave's tokens on the same step")
        fresh = eng.InferenceEngine(model, checkpoint=str(work / "ckpt"),
                                    cfg=scfg, device=dev)
        with fresh:
            hs = [fresh.submit(p, RELOAD_NEW) for p in prompts]
            fresh_tokens = [h.result(timeout=900).tokens for h in hs]
        new_tokens = [a["tokens"] for a in wave2]
        new_equal = new_tokens == fresh_tokens
        agreement = token_agreement(new_tokens, fresh_tokens)
        tf_top1 = None
        if not new_equal:
            tf_top1 = teacher_forced_served(torch, ttr, tmm, cfg, fresh,
                                            prompts, new_tokens, dev)
            if tf_top1 < TOL_TOP1_BF16:
                fail(f"reloaded tokens vs a fresh engine on step {final}: "
                     f"{agreement}, teacher-forced top-1 {tf_top1}")
        del fresh
        for label, ln in (("serving", serve_launches),
                          ("reload", reload_launches)):
            if expect_launches and (ln["int8_matmul"] <= 0
                                    or ln["paged_attention"] <= 0):
                fail(f"{label} from the checkpoint did not run through its "
                     f"kernels: {ln}")
        changed = token_agreement(new_tokens, [a["tokens"] for a in wave0])
        serve = {"int8_rows": {1: sum(len(p) - 1 for p in prompts),
                               scfg.slots: d0["serving.decode.dispatches"]},
                 "paged_steps": d0["serving.decode.dispatches"],
                 "launches": serve_launches, "open_s": open_s,
                 "wall_s": serve_s, "tokens_per_s": d0["serving.tokens"]
                 / serve_s}
        reload = {"int8_rows": {1: 2 * sum(len(p) - 1 for p in prompts),
                                scfg.slots: d1["serving.decode.dispatches"]},
                  "paged_steps": d1["serving.decode.dispatches"],
                  "launches": reload_launches, "reload_s": reload_s,
                  "staged": staged, "in_flight_equal_first_wave": old_equal,
                  "after_equal_fresh_engine": new_equal,
                  "after_vs_fresh": agreement, "teacher_forced_top1": tf_top1,
                  "step10_vs_step8_tokens": changed,
                  "engine_stats": stats}
        more = {"batch": batch, "seq": seq, "causal": cfg.causal,
                "losses": more_losses, "launches": more_launches,
                "saves": more_snap["timers"]["checkpoint.save"]["count"]}
        print(f"serve from checkpoint: engine opened step {CKPT_STEPS} in "
              f"{open_s:.2f} s, 8 requests over HTTP in {serve_s:.2f} s, "
              f"launches={serve_launches}", flush=True)
        print(f"hot reload: 2 more steps published step {final} (losses "
              f"{[round(v, 5) for v in more_losses]}); /v1/reload -> "
              f"{got_step} in {reload_s:.3f} s with 8 requests in flight "
              f"(staged until they finished: {staged}); in-flight stamps "
              f"{sorted(s1)} tokens equal the first wave: {old_equal}; later "
              f"stamps {sorted(s2)} tokens equal a fresh engine on step "
              f"{final}: {new_equal} {agreement}; step {final} vs step "
              f"{CKPT_STEPS} tokens: {changed}; launches={reload_launches}",
              flush=True)
        leg = {"batch": batch, "seq": seq, "causal": cfg.causal,
               "launches": {k: launches[k] + more_launches[k]
                            for k in launches}}
        return {"train": train, "serve": serve, "more": more,
                "reload": reload, "leg": leg}
    finally:
        pool.shutdown(wait=True)
        tobs.FLIGHTREC.dump_dir = old_dump
        shutil.rmtree(work, ignore_errors=True)


def teacher_forced_served(torch, ttr, tmm, cfg, engine, prompts, served, dev):
    """Top-1 agreement of ``served`` continuations with the greedy picks of
    ``engine``'s serving tree fed the same tokens (one row at a time
    through ``decode_step``)."""
    with engine._lock:
        sp = engine._params
    agree = total = 0
    with torch.no_grad():
        for prompt, toks in zip(prompts, served):
            seq = list(prompt) + list(toks)
            cache = ttr.init_decode_cache(cfg, 1, dev)
            for i in range(len(seq) - 1):
                logits, _ = ttr.decode_step(sp, cache, torch.tensor(
                    [seq[i]], device=dev), i, cfg)
                if i + 1 >= len(prompt):
                    agree += int(int(logits[0].argmax()) == seq[i + 1])
                    total += 1
    return agree / total


def print_ptxas(usage) -> None:
    """Registers, spills and static shared memory of the bf16 kernels,
    from the builds' ``ptxas -v`` reports (every kernel's are in the
    report)."""
    for n in ("flash_attention", "blocked_xent", "paged_attention",
              "int8_matmul"):
        for r in usage.get(n, []):
            if ("f32" in r["kernel"] if n in ("flash_attention",
                                              "blocked_xent")
                    else "__nv_bfloat16" not in r["kernel"]):
                continue
            print(f"ptxas {n}: {r['kernel'][:110]} registers="
                  f"{r.get('registers')} spill_stores={r.get('spill_stores')} "
                  f"spill_loads={r.get('spill_loads')} static_smem="
                  f"{r.get('static_smem')}", flush=True)


def one_source(torch, root: Path, rates, report, name: str) -> int:
    """``--paged-only`` / ``--int8-only``: build ``csrc/<name>.cu`` of the
    tree at ``root`` and run its phase-2 cases alone (to time two versions
    of a kernel on one card, one process each); prints the cases as one
    JSON line."""
    from deeplearning4j_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.load(name)
    print(f"{name}-only: {root} build_s={time.perf_counter() - t0:.2f}",
          flush=True)
    usage = {name: build.resource_usage(name)}
    print_ptxas(usage)
    cases: list[dict] = []
    result = {"root": str(root), "card": card_line(), "ptxas": usage}
    if name == "paged_attention":
        from deeplearning4j_tpu_torch.ops.cuda import kv_quant
        from deeplearning4j_tpu_torch.ops.cuda import paged_attention as tpa
        check_paged(torch, tpa, kv_quant, "cuda", rates, cases)
    else:
        from deeplearning4j_tpu_torch.ops.cuda import matmul_int8 as tmm
        check_int8(torch, tmm, "cuda", rates, cases)
        result["int8_matmul_dx_err"] = check_int8_grad(torch, tmm, "cuda")
        result["int8_matmul_device_kernels"] = check_int8_one_launch(
            torch, tmm, "cuda")
    result["cases"] = cases
    if report:
        Path(report).parent.mkdir(parents=True, exist_ok=True)
        Path(report).write_text(json.dumps(result, indent=1))
    print(json.dumps({"root": str(root), "cases": cases}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", help="also write the full report (JSON) here")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--paged-only", action="store_true",
                      help="build and time the paged-attention kernels alone")
    only.add_argument("--int8-only", action="store_true",
                      help="build, check and time int8_matmul alone")
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose deeplearning4j_tpu_torch runs "
                         "(default: this script's)")
    args = ap.parse_args()
    root = Path(args.root).resolve()

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    if not (root / "deeplearning4j_tpu_torch" / "csrc").is_dir():
        fail(f"{root} holds no deeplearning4j_tpu_torch checkout")
    sys.path.insert(0, str(root))
    if args.paged_only or args.int8_only:
        return one_source(torch, root, rates_for(
            torch.cuda.get_device_name(0)), args.report,
            "paged_attention" if args.paged_only else "int8_matmul")
    import numpy as np

    from deeplearning4j_tpu_torch import serving
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.ops.cuda import attention as tat
    from deeplearning4j_tpu_torch.ops.cuda import build, kv_quant
    from deeplearning4j_tpu_torch.ops.cuda import layernorm as tln
    from deeplearning4j_tpu_torch.ops.cuda import matmul_int8 as tmm
    from deeplearning4j_tpu_torch.ops.cuda import paged_attention as tpa
    from deeplearning4j_tpu_torch.ops.cuda import xent as txe
    from deeplearning4j_tpu_torch.optimize import transforms as TT
    from deeplearning4j_tpu_torch.serving import engine as eng
    from deeplearning4j_tpu_torch.serving import ModelServer, ServingClient

    card = card_line()
    name = torch.cuda.get_device_name(0)
    rates = rates_for(name)
    build_s = build.build_all()
    print(f"card: {card} | build_s={build_s:.2f} (nvcc -gencode "
          f"arch=compute_90a,code=sm_90a, {len(build.sources())} sources) | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | rates "
          f"{rates[0] / 1e12:.2f} TB/s, {rates[1] / 1e12:.0f} TFLOP/s bf16",
          flush=True)
    usage = {n: build.resource_usage(n) for n in build.sources()}
    print_ptxas(usage)

    # ---- 2. each kernel against its plain version
    cases: list[dict] = []
    check_int8(torch, tmm, "cuda", rates, cases)
    int8_dx = check_int8_grad(torch, tmm, "cuda")
    int8_kernels = check_int8_one_launch(torch, tmm, "cuda")
    if any(len(v) != 1 for v in int8_kernels.values()):
        fail(f"an int8_matmul call is not one device kernel: {int8_kernels}")
    check_paged(torch, tpa, kv_quant, "cuda", rates, cases)
    check_attention(torch, tat, "cuda", rates, cases)
    check_layernorm(torch, tln, "cuda", rates, cases)
    check_xent(torch, txe, "cuda", rates, cases)
    print(json.dumps({"kernel_cases": cases}), flush=True)

    # ---- 3./4. the serving main path at full width
    mcfg = ttr.TransformerConfig()            # full width, 12 layers, bf16
    tmodel = ttr.TransformerLM(mcfg, device="cuda")
    params = tmodel.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    wrappers = (tmm.int8_matmul, tpa.paged_attention,
                tpa.paged_attention_int8, tat.flash_attention,
                tat.fused_attention, tln.fused_residual_layernorm,
                txe.blocked_cross_entropy)
    cfg_a = eng.ServingConfig(slots=8, paged=True, page_size=16,
                              int8_decode=True, paged_attention_impl="pallas")
    prompts_a = make_prompts(rng, 16, mcfg.vocab_size)
    engine_a, rep_a = run_engine(eng, tmodel, params, cfg_a, prompts_a,
                                 wrappers, "engine A")
    la = rep_a["launches"]
    if la["int8_matmul"] <= 0 or la["paged_attention"] <= 0:
        fail(f"engine A did not run through its kernels: {la}")
    tf_a = kernels_vs_plain(torch, ttr, tmm, tpa, kv_quant, mcfg, params,
                            False, "engine A")
    rep_a["teacher_forced"] = tf_a
    print(engine_line("engine A", rep_a) + f" teacher_forced={tf_a}",
          flush=True)

    # ---- 5. the HTTP front end over engine A
    with ModelServer(engine_a) as server:
        client = ServingClient(port=server.port, timeout_s=300)
        answers = [client.generate(rng.integers(0, mcfg.vocab_size, n)
                                   .tolist(), max_new_tokens=8)
                   for n in (16, 40)]
        health = client.healthz()
    engine_a.stop()
    if [len(a["tokens"]) for a in answers] != [8, 8] or not health["ok"]:
        fail(f"server answers {answers} / health {health}")
    print(f"server: 2/2 requests answered over HTTP, completed="
          f"{health['engine']['completed']}", flush=True)
    del engine_a

    cfg_b = eng.ServingConfig(slots=8, paged=True, page_size=16,
                              int8_decode=True, kv_quant="int8",
                              paged_attention_impl="pallas_int8")
    engine_b, rep_b = run_engine(eng, tmodel, params, cfg_b,
                                 make_prompts(rng, 8, mcfg.vocab_size),
                                 wrappers, "engine B")
    engine_b.stop()
    lb = rep_b["launches"]
    if lb["int8_matmul"] <= 0 or lb["paged_attention_int8"] <= 0:
        fail(f"engine B did not run through its kernels: {lb}")
    tf_b = kernels_vs_plain(torch, ttr, tmm, tpa, kv_quant, mcfg, params,
                            True, "engine B")
    rep_b["teacher_forced"] = tf_b
    print(engine_line("engine B", rep_b) + f" teacher_forced={tf_b}",
          flush=True)
    del engine_b

    # ---- 5b. the speculative engine S: engine A's config and prompts,
    # a random one-layer draft proposing 3 tokens a verify window
    draft_model, draft_params = zoo.draft_lm(mcfg, device="cuda")
    cfg_s = eng.ServingConfig(slots=8, paged=True, page_size=16,
                              int8_decode=True, paged_attention_impl="pallas",
                              speculative=True, spec_k=3)
    engine_s, rep_s = run_engine(eng, tmodel, params, cfg_s, prompts_a,
                                 wrappers, "engine S",
                                 draft_model=draft_model,
                                 draft_params=draft_params)
    engine_s.stop()
    del engine_s, draft_params
    if rep_s["launches"]["int8_matmul"] <= 0:
        fail(f"engine S did not run through its kernels: {rep_s['launches']}")
    rep_s["agreement_with_a"] = token_agreement(rep_s["served"],
                                                rep_a["served"])
    rep_s["teacher_forced"] = window_vs_steps(torch, ttr, tmm, tpa, mcfg,
                                              params)
    print(engine_line("engine S", rep_s) + " agreement with engine A: "
          f"{rep_s['agreement_with_a']} teacher_forced window vs steps="
          f"{rep_s['teacher_forced']}", flush=True)

    # ---- 5c. the prefix cache on float and int8 pages; 5d. beam search
    prefix = run_prefix(eng, tmodel, params, rng, wrappers)
    beam = run_beam(torch, ttr, tmm, tmodel, params, wrappers)
    del tmodel, params
    torch.cuda.empty_cache()

    # ---- 6./7. the train step at full width: the BERT-base leg (flash,
    # bidirectional) and the default causal config (fused, remat)
    cfg_a = ttr.TransformerConfig(
        vocab_size=32768, d_model=768, n_heads=12, n_layers=12, d_ff=3072,
        max_len=512, causal=False, dtype=torch.bfloat16, remat=False,
        attention="flash", fused_ln=True, xent_impl="blocked")
    cfg_b = ttr.TransformerConfig(attention="fused", fused_ln=True,
                                  xent_impl="blocked")
    # ---- 5e. sample(kv_cache=False) on the causal config; 5f. the
    # BatchScorer behind ModelServer on leg A's config
    sample = run_sample(torch, ttr, wrappers)
    scorer = run_scorer(torch, ttr, serving, cfg_a, wrappers, rng)
    torch.cuda.empty_cache()
    leg_a = train_leg(torch, ttr, TT, cfg_a, 64, 512, 5, "train A",
                      wrappers, rates, profile=True)
    leg_b = train_leg(torch, ttr, TT, cfg_b, 8, 2048, 3, "train B",
                      wrappers, rates, profile=True)

    # ---- 8. one step through the kernels against the plain versions
    step_a = step_kernels_vs_plain(torch, ttr, tat, tln, txe, cfg_a,
                                   "train A")
    step_b = step_kernels_vs_plain(torch, ttr, tat, tln, txe, cfg_b,
                                   "train B")
    torch.cuda.empty_cache()

    # ---- 8b. checkpoints, the supervised trainer under faults, serving
    # from the checkpoint and hot reload (default causal config, 8 x 512)
    ckpt = run_checkpoints(torch, ttr, TT, tmm, tat, tln, txe, eng, wrappers,
                           rng)

    # ---- 9. one line per kernel: its numbers weighted by this run's
    # launches at each main-path shape, and every shape measured
    kernels = kernel_rows(
        cases, [rep_a, rep_b, rep_s, prefix["float"]["cache"],
                prefix["int8"]["cache"], beam, ckpt["serve"], ckpt["reload"]],
        [leg_a, leg_b, sample["bfloat16"], scorer, ckpt["leg"]], mcfg, rates)
    if args.report:
        path = Path(args.report)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({
            "card": card, "device": name, "build_s": build_s,
            "ptxas": usage,
            "kernel_cases": cases, "int8_matmul_dx_err": int8_dx,
            "int8_matmul_device_kernels": int8_kernels,
            "engine_a": rep_a, "engine_b": rep_b, "engine_s": rep_s,
            "prefix": prefix, "beam": beam, "sample": sample,
            "scorer": scorer, "train_a": leg_a, "train_b": leg_b,
            "step_vs_plain": {"train_a": step_a, "train_b": step_b},
            "checkpoints": ckpt,
            "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
