#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]
    python3 chip_smoke.py --paged-only [--root DIR] [--report PATH]
    python3 chip_smoke.py --int8-only [--root DIR] [--report PATH]

Builds the port's CUDA kernels from ``deeplearning4j_tpu_torch/csrc`` (one
``nvcc`` per source, started together), holds each kernel against its
plain PyTorch version at the shapes of the port's main paths (paged int8
serving, the flagship train step and the DL4J stack), then drives those
paths through the entry points a user calls:

1. the card (``nvidia-smi`` name and power limit), the build time and
   every kernel's registers, spills and static shared memory (``ptxas -v``);
2. ``int8_matmul`` at M in {1, 4, 8, 32} (a prefill token, beam search's
   width, the engines' slots, a speculative verify window) over the FFN
   and LM-head weights (and its input gradient at the FFN shapes against
   the plain version's; and, under ``torch.profiler``, that a call at each
   of those shapes is one device kernel), and
   ``paged_attention`` / ``paged_attention_int8`` (over int8 and over
   fp8 pages, the fp8 cases on the int8 cases' lengths and values) at
   B=8, H=12, Dh=64, page 16, 128 pages per row: at the engines' own
   lengths (16-288 positions, Kv=12, the main-path case) and at
   long-context lengths of 1-2048 (Kv in {12, 4}), also held to the
   registry's bands (max error 0.05, and top-1 >= 0.999 of each output
   vector in float32); then the forward kernels: ``flash_attention`` and
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
5a. engine F: as B with ``kv_quant="fp8"`` (e4m3 pages), on A's first 4
   prompts (not all 16: the script's time limit), with B's teacher-forced
   comparison;
5b. the disaggregated tier (``run_disagg``): a ``DisaggScheduler`` over
   one ``role="prefill"`` and one ``role="decode"`` engine (A's serving
   config with the prefix cache) serving A's first 4 prompts on float
   pages,
   then on fp8 pages: the tokens equal engine A's, then engine F's; a
   129-token prompt served twice (its second migration claims its 8
   pages by hash and moves no byte); that prompt migrated over HTTP
   (``ModelServer`` over the scheduler, ``export_payload``,
   ``ServingClient.migrate_probe`` / ``migrate``) with full bytes and as
   probed; pages moved and deduped, bytes moved and migration ms;
6. engine S: as A with ``speculative=True, spec_k=3`` and the random
   one-layer ``zoo.draft_lm`` draft, on A's first 4 prompts (tokens/s, TTFT, the
   step, ``serving.spec_accept_len``, its served tokens against A's), and
   teacher-forced verify windows (``decode_window_paged``, ``int8_matmul``
   at M=32) against sequential steps through the plain versions, in bf16
   and float32;
7. the prefix cache: 8 requests sharing a 128-token system prompt (with
   suffixes of 16-64 tokens, 16 new tokens each) on A's and on B's
   config with ``prefix_cache=True`` against the same with ``False`` on
   the first 4 of them: the hit rate, and float pages' tokens equal;
8. ``beam_search`` at width 4, 8 tokens, over the int8 serving tree;
8b. the router phase (``run_router``): 12 requests of 4 tenants (a
   128-token system prompt each) through two engines (A's config with the
   prefix cache) behind ``PrefixRouter`` and ``RouterServer`` over HTTP,
   held to one engine's tokens and hit rate, with affinity, one trace id
   from the client to the engines' spans, exact tenant accounts,
   ``serving.decode_mfu``/``decode_mbu`` in (0, 1], SLO burn rates read
   back through a ``StatusServer`` scrape; the brownout ladder, an
   over-quota tenant's 429 and an autoscaler scaling up by a warmed
   replica and back down; a ``ProcessReplica`` of the same engine joining
   the ring (tokens equal, its ``/metrics.prom`` federated), killed: its
   key spills or answers 503 and its quarantine leaves a bundle;
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
   requests carry step 10's and equal a fresh engine's on step 10; the
   trainer's live ``train.mfu`` is held to this script's MFU of the same
   step within ``TOL_TRAIN_MFU``;
14b. the online loop (``run_online``) on the checkpoint phase's config
   and size: ``ModelServer(capture=CaptureStore)`` over an engine on a
   ``CheckpointManager`` answers 4 requests; ``OnlineLoop.run_once``
   fine-tunes 2 steps on the captured and synthetic records, publishes
   and hot-reloads (``loaded_step`` 2, a later request stamped so); a
   round whose publish is poisoned rolls back to step 2;
15. the DL4J network stack (``run_dl4j``), the README's first entry
   point: seeded MNIST-shaped IDX files (60,000 images, labels from a
   linear teacher) in a temporary ``DL4J_TPU_DATA``; ``python -m
   deeplearning4j_tpu_torch train --model dbn --dataset mnist --batch
   8192 --out ...`` and ``evaluate`` as subprocesses (exit codes 0, the
   IDX files read, F1 over 3x chance, ``evaluate`` printing ``train``'s
   stats again); the same DBN (784-500-250-10, CD-1 RBMs, a softmax
   finetune) fit in process with its iterations cut (per-layer pretrain
   step, finetune iteration, fit, examples/s, ``evaluate``), then
   ``losses.score("blocked_mcxent", y, (h, head))`` on its 250-wide head
   through ``blocked_cross_entropy`` in float32 against its plain
   version; ``zoo.mlp(784, 10)`` (50 iterations), ``zoo.lenet(10)`` (10)
   and Hessian-free (3, its CG solves under
   ``torch.cuda.set_sync_debug_mode("error")``) on the card against the
   CPU from the same parameters, within ``TOL_DL4J`` (the two AdaGrad
   fits through their float32 loss and gradients at the start, the
   whole fit in float64 and the float32 output at the CPU fit's
   parameters: see the comment above ``TOL_DL4J``);
15b. ResNet-50 training (``run_resnet``; bf16, s2d stem, 1000 classes):
   the JAX package's benchmark leg — ``value_and_grad(cross_entropy)``
   and ``chain(momentum(0.9), sgd_lr(1e-2))`` at batch 256 x 224^2 from
   a seeded numpy generator, one warm-up and 10 steps on a fixed batch
   timed on CUDA events (p50 step, images/s, MFU against
   ``flops_per_image(224)``, peak memory; the loss finite and falling)
   and one profiled step (device time by class: cuDNN convolutions,
   layout transposes, BN statistics, the elementwise rest); ResNet-18
   (width 8, f32, 32^2) forward and one ``train_step`` on the card
   against the CPU within ``TOL_RESNET_CARD``; ResNet-50's bf16 loss
   within ``TOL_RESNET_BF16`` of its f32 loss on 32 images;
15c. the LSTM sequence model (``run_lstm``), ``examples/05``'s flow:
   20 epochs on the card and the CPU from the same parameters (losses
   within ``TOL_LSTM``, ``predict_next``, beams and samples equal),
   then to 110 epochs on the card, beam search continuing "abc" with
   "defg", and 200 sampled tokens (tokens/s);
15d. the text pipeline (``run_text``): the native host library must
   load; a seeded ~800k-token, ~10k-word Zipfian topic corpus; Word2Vec
   at the reference's defaults but subsampling 1e-3 (without it both
   packages diverge there) with hierarchical softmax and with 5
   negatives, GloVe on a fifth of it and ParagraphVectors on 4000
   sentences (pairs/s, entries/s, the host's share of each fit;
   within-topic similarity above cross-topic); a small HS fit on the
   card against the CPU within ``TOL_W2V_CARD``; ``examples/08``'s
   svmlight flow (native parse equal to Python's, byte-range splits,
   ``zoo.mlp`` fit from the file on the card against the CPU);
15e. raw text to a trained RNTN (``run_trees``): 1,200 seeded sentences
   of 8-24 tokens over the tagger's sample vocabulary and SentiWordNet's
   seed words, split by ``SentenceAnnotator``, parsed by
   ``TreebankParser`` and binarized on the host (seconds), every node
   labelled with SentiWordNet's judgment as an SST class 0-4;
   ``RNTN(layer_size=25, n_classes=5, max_nodes=64)`` fit 4 epochs at
   batch 32 on the card (p50 step, trees/s, the loss falling, root
   accuracy above the majority class), held to the CPU from the same
   parameters (the float32 loss and gradients of a batch, 20 AdaGrad
   steps in float64, within ``TOL_DL4J``); ``pos_tag_viterbi`` over 200
   sentences, the tags equal the CPU's; an ``InvertedIndex`` saved,
   loaded and searched alike;
15f. clustering and t-SNE (``run_embed_plot``) over 15d's
   negative-sampling Word2Vec table (~10k x 100), with TF32 on for the
   process: ``KMeansClustering(k=20)`` (sweeps, ms a sweep; inertia
   and labels against the CPU within ``TOL_KMEANS``), exact ``Tsne()``
   at its defaults over the 5,000 most frequent words (the host's
   perplexity search, ms an iteration, KL; P and 10 float64 iterations
   against the CPU; one topic's words closer in 2-D than two topics'),
   and ``render_word_vectors(model)``'s ``/api/coords``, 500 finite
   points.  No kernel of the port lies on 15b-15f: their launch counts
   must stay 0;
15g. the data-parallel tier (``run_data_parallel``) at leg A's config and
   global batch (64 x 512, split over the ranks; SGD with momentum):
   one rank in this process over NCCL — ``DataParallelTrainer`` at ZeRO
   stages 0-3 and hogwild, and ``TransformerLM(cfg, mesh)``'s
   ``build_train_step(zero1=True)`` against ``zero1=False``; NCCL
   refusing two spawned ranks on one GPU; two spawned ranks sharing the
   card over gloo — the same stages (each held to stage 0, stage 0 to
   dp=1, p50 step ms on CUDA events, tokens/s, the collectives' host ms
   a step and the gloo calls staged through host memory), the per-rank
   optimizer-state bytes (stage 2 / stage 0 ~ 1/2), a ZeRO-2 checkpoint
   written at dp=2 and restored here at dp=1 (its next loss held);
   then four spawned ranks: ``TrainingSupervisor.fit`` over a trainer
   factory, ``mesh.shrink`` losing 2 ranks at step 3 and ``mesh.grow``
   taking them back at step 4, every recovered loss within
   ``TOL_DP_ELASTIC`` of the un-faulted run (resize and reshard
   seconds).  Each rank's launches of #1/#3/#4 join the kernels line at
   the rows that rank ran;
15h. the model-parallel axes (``mp_rank_job``, on 15g's four elastic
   ranks after their run; ``run_model_parallel`` spawns its own for the
   phase alone) at the flagship's full width, sharing the card over
   gloo, SGD with
   momentum, one warm-up and two timed steps a leg: tensor parallel (leg
   A's config on dp2·tp2, global 16 x 512: ``flash_attention`` on 6
   local heads), sequence parallel (the causal config with ring
   attention on sp2·tp2, global 4 x 2048: 1,024 positions a rank) and
   the GPipe pipeline (``PipelinedTransformerLM`` on leg B's config,
   pp2·dp2, 4 micro-batches, global 8 x 2048), each held against the
   same config's one-device step on the same global batch (p50 step ms,
   tokens/s, the collectives' host ms and bytes a step by axis, the
   calls staged through host memory, peak memory a rank); the pipeline's
   ZeRO-1 step against its replicated one, and its ZeRO-1 state saved
   from the mesh and restored into a one-device ``TransformerLM`` (its
   next loss held); ``ShardedWord2Vec`` (HS, NS) and ``ShardedGlove``
   over ep=4 on a seeded topic corpus against the one-device fits,
   beside ``python -m deeplearning4j_tpu_torch dryrun --devices 8`` (exit
   0 and the ``dryrun_multichip OK`` line).  #1 at the tp shape has its own
   case among phase 2's;
15i. the host control plane (``run_control_plane``): a. the ``Driver``
   (leg A's config, SGD with momentum, 16 x 512, 6 steps, a checkpoint
   every 3 and a status port) joining one NCCL rank through the launch
   contract (MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK), stopped after 3
   steps with ``/status`` and ``/metrics`` answered mid-run, a second
   Driver resuming from its save over the whole stream, and a supervised
   one (``RetryPolicy``) through an injected step-4 fault: every run's
   losses and params bitwise those of ``DataParallelTrainer.fit`` on its
   mesh (p50
   step ms, tokens/s, save and restore s, the checkpoint's bytes, peak
   memory); b. the scaleout word2vec with its steps on the card, three
   hogwild worker threads, HS and NS: the reference test's corpus (its
   similarity ordering) and a seeded 50k-token topic corpus
   (within-topic above cross-topic, s a fit, words/s), and one
   iterative-reduce worker against the CPU within ``TOL_CTL_W2V``; c./d.
   the process legs at once: ``ProcessDistributedRunner`` with two host
   worker processes on the word count (exact) while ``wave_actuators``
   grows the wave by a third process and retires an idle worker, and on
   the svmlight superstep (equal to the thread runner's); a ``python -m
   deeplearning4j_tpu_torch scaleout`` master (one worker) stopped by
   ``scaleout -t kill``; ``provision --dry-run-apply`` with a stub
   ``gcloud`` that must not run; every worker recording that it imported
   no ``jax`` or ``deeplearning4j_tpu`` and initialised no CUDA.  The
   Driver runs' launches of #1/#3/#4 join the kernels line;
15j. the analysis tier's runtime guards (``run_guards``, after beam
   search, on the flagship model).  Every serving and training phase
   already runs under ``hot_loop_guard()`` (the guard is on by
   default): each engine's decode segments are counted and any refusal
   fails the run (engine A's line prints them, and engine A's
   dispatches run under ``SHARDGUARD`` with 0 violations, as do 15g's
   stages here and on the dp=2 ranks, enabled there by
   ``DL4J_TPU_SHARDGUARD=1``; the disaggregated tier runs under the
   port's ``LOCKGUARD`` with the decode engine watched, 0 violations).
   15j itself: on one thread inside the guard ``.item()``,
   ``float``/``bool`` of a CUDA tensor, ``nonzero``, ``.cpu()``,
   ``.tolist()`` and a pageable upload raise at their call site, a
   pinned ``non_blocking`` upload passes, ``allow_transfers()``
   re-allows them all and ``log`` mode counts them; meanwhile a second
   thread makes the same reads unguarded and passes; two engines
   (engine A's config) serve 4 requests each from their own threads at
   once under the guard, tokens equal to their unguarded runs, no
   refusal; the guard's cost: engine A's decode step p50 on 8 short
   prompts (32 new tokens) and ``fit``'s p50 step at 15i's Driver
   config (16 x 512, 5 steps), the guard off and on (off, on, on, off
   in turn, the tokens and losses equal in every mode; ``guard_probe.py``
   times the dispatch-mode alternative the same way); a parameter placed
   on the host fed to ``train.sync_step``: exactly one
   ``resharded-input`` violation and the gauge at 1;
16. a ``{"kernels": [...]}`` JSON line (each path's launches counted from
   0 just before it runs, read just after; #7 has a row per page type,
   ``paged_attention_int8`` and ``paged_attention_fp8``), then the card's
   name and power limit, then ``{"ok": true, "device": {...}}`` as the
   last line.  A kernel module that fails to import
   (``registry.import_errors()``) fails the run after the build.

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
import contextlib
import json
import os
import subprocess
import sys
import tempfile
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
# and the registry's bands of the paged kinds (ops/cuda/paged_attention.py):
# max error, and the top-1 agreement of each (row, head) output vector
TOL_PAGED_REGISTRY = 0.05
TOL_PAGED_TOP1 = 0.999
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
#: 8 x 2048), the checkpoint phase (8 x 512) and a rank of the
#: data-parallel phase at dp=4 (16 x 512)
TRAIN_ROWS = (32768, 16384, 4096, 8192)
#: rows of the LN calls: the training legs' (the scorer's 32 x 512 is leg
#: B's count) and the full-forward sampler's one row of 2048
LN_ROWS = TRAIN_ROWS + (2048,)

#: the DL4J phase (run_dl4j): the CLI's DBN on MNIST-shaped data,
#: ``train --batch 8192`` (its first 8192 of 60,000 images)
DL4J_IMAGES = 60000
DL4J_ROWS = 8192
#: the timed in-process DBN: iterations cut from the zoo's 100 / 200
DL4J_PRETRAIN_IT = 20
DL4J_FINETUNE_IT = 30
# card against CPU on the deterministic paths: max over the parameter
# leaves of max |card - cpu| / max |cpu|, and the relative error of the
# final parameters' loss, both sides scored in float64 on the CPU.  The
# loss the fit last read in float32 is reported, not held: near a
# confident fit it is a mean of -log(p) with p within a few ulps of 1,
# where the card's and the CPU's exp and log round differently (the
# mlp's read 2.3e-4 apart on an H100 with its parameters 1.4e-5 apart).
#
# The AdaGrad fits (mlp 50 iterations, LeNet 10) are not held
# free-running in float32: there the CPU side is no fixed reference.
# AdaGrad's first step is lr * g / sqrt(g^2 + 1e-6), which multiplies
# the rounding of a gradient that cancels to near 0 by up to
# lr / 1e-3 = 100, and later steps carry it on.  ``dl4j_cpu_spread.py``
# runs the same fits on the CPU at other thread counts: on an 8-core
# Xeon (AVX-512) LeNet's fit moves 4.4e-4 at 2 or 4 threads instead of
# 8, the mlp's up to 1.1e-5; and two H100 machines' runs of this
# script, one card type and one code, read the mlp's float32 fits
# 1.4e-5 and 3.55e-4 apart (the float64 losses 7.2e-5 and 8.0e-4).  So
# each such fit is held where it is well conditioned
# (``first_order_card_vs_cpu``): the float32 loss and every gradient
# leaf at the starting parameters (each leaf against its own largest
# |gradient|: up to 1.8e-5 between the CPU's own runs), the whole fit
# through ``fit`` in float64 on both sides (0 between the CPU's runs at
# any thread count), and the float32 output at the CPU fit's final
# parameters, each within TOL_DL4J; the float32 fit itself is reported.
# The Hessian-free fit (3 iterations) is held free-running in float32:
# the same runs with the batch rows permuted moved it 1.3e-7.  (LeNet
# on binarized pixels is no test of the card: its 2x2 max pools meet
# exact ties that rounding breaks either way.)
TOL_DL4J = 1e-4
# losses.score("blocked_mcxent", y, (h, head)) through kernel #4 against
# its plain version: the xent registry entry's max_err
TOL_DL4J_XENT = 1e-3
# float32 FMA rates outside the tensor cores, by product name (NVIDIA's
# data sheets), for the f32 kernel call's bound
F32_RATES = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H200": 67e12,
             "H100": 67e12}

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
    # one session first, its records discarded: the first sessions of a
    # process have recorded no kernel three times running on an H100
    # (CUPTI starting up), which no later session showed
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
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
#: engines F and S serve engine A's first FS_PROMPTS prompts (8 before
#: phase 15j; the disaggregated tier's DISAGG_PROMPTS are among them)
FS_PROMPTS = 4
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
    # the fp8 pages' cases replay the int8 cases' draws (the same lengths
    # and values), so the two page types compare like for like
    int8_draws = {}
    for mode in (None, "int8", "fp8"):
        quant = mode is not None
        for Kv, lrange in ((12, LONG_LENGTHS), (4, LONG_LENGTHS),
                           (12, ENGINE_LENGTHS)):
            g = gen_engine if lrange == ENGINE_LENGTHS else gen
            if mode == "int8":
                int8_draws[Kv, lrange] = g.get_state()
            elif mode == "fp8":
                g = torch.Generator(device=dev)
                g.set_state(int8_draws[Kv, lrange])
            q, k, v, bt, lengths = paged_inputs(torch, dev, g, Kv, quant,
                                                lengths_range=lrange)
            B, H, Dh = q.shape
            P, ps = k.shape[:2]
            if quant:
                sdt = kv_quant.storage_dtype(mode)
                s0 = torch.full((P, Kv), kv_quant.neutral_scale(sdt),
                                device=dev)
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
                                                      sdt)
                    vq, vs = kv_quant.requantize_pool(v, s0, sdt)
                    pools.append((kq, vq, ks, vs))
                else:
                    pools.append((k.to(torch.bfloat16) * (1 + 0.01 * i),
                                  v.to(torch.bfloat16)))
            # the fp8 pages' cases run the same wrapper, under a name of
            # their own in the report (kernel_rows: PAGED_ROWS)
            name = {None: "paged_attention", "int8": "paged_attention_int8",
                    "fp8": "paged_attention_fp8"}[mode]
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
                    and torch.isfinite(out).all().item()
                    and err < TOL_PAGED_REGISTRY):
                fail(f"{name} Kv={Kv} bf16: max err {err} (tol {atol} + "
                     f"{rtol} |ref|, and below {TOL_PAGED_REGISTRY})")
            out32 = kern(*args32, bt, lengths)
            e32 = (out32 - ref).abs().max().item()
            # top-1 of each (row, head) output vector, float32 kernel
            # against the plain version
            top1 = (out32.argmax(-1) == ref.argmax(-1)).float().mean().item()
            if not (e32 < TOL_ATTN_F32 and top1 >= TOL_PAGED_TOP1):
                fail(f"{name} Kv={Kv} float32: max err {e32} (tol "
                     f"{TOL_ATTN_F32}), top-1 {top1} (floor "
                     f"{TOL_PAGED_TOP1})")
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
                          "top1_f32": top1,
                          "ms": ms, "plain_ms": pms,
                          "library_ms": lms, "bound_ms": bound,
                          "bound_by": "bytes" if nbytes / bw >= ops / peak
                          else "operations", "bytes": nbytes, "ops": ops})
            print(f"kernel {name} B={B} H={H} Kv={Kv} lengths {lrange[0]}-"
                  f"{lrange[1]} mean_len={valid / B:.1f}: max_err bf16={err:.3g} (tol {atol} + {rtol:.4g} |ref|) "
                  f"f32={e32:.3g} (tol {TOL_ATTN_F32}) top1_f32={top1} "
                  f"kernel_ms={ms:.5f} "
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
#: (32 rows of leg A's 512) and the checkpoint phase's (8 x 512, causal);
#: a fifth element is the heads (12 without it): 15h's tp rank attends
#: over 6 heads of 8 x 512
ATTN_CASES = (("flash_attention", 64, 512, False),
              ("fused_attention", 8, 2048, True),
              ("flash_attention", 8, 2048, True),
              ("fused_attention", 64, 512, False),
              ("fused_attention", 1, 2048, True),
              ("flash_attention", 32, 512, False),
              ("fused_attention", 8, 512, True),
              ("flash_attention", 16, 512, False),
              ("flash_attention", 8, 512, False, 6))


def check_attention(torch, tat, dev, rates, cases, H=12, Dh=64):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(3)
    heads = H
    for name, B, T, causal, *h in ATTN_CASES:
        H = h[0] if h else heads
        frontier = name == "fused_attention"
        # q/k/v as the strided views of packed (B,T,3,H,Dh) projections,
        # as the train step hands them over; enough copies to exceed the L2
        packs = [torch.randn((B, T, 3, H, Dh), generator=gen, device=dev)
                 .to(torch.bfloat16)
                 for _ in range(copies_for(B * T * 3 * H * Dh * 2))]
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


def profile_step(torch, step, params, opt, batch, classify=None):
    """One train step under ``torch.profiler``: device time by kernel name
    and by class (``classify``, by default :func:`kernel_class`), and the
    device's busy share of the step's wall time (one stream, so kernel
    times add up without overlap)."""
    classify = classify or kernel_class
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
        by_class[classify(n)] += us / 1e3
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
                       if (leg["batch"], leg["seq"], leg["causal"],
                           leg.get("heads", mcfg.n_heads))
                       == (case["B"], case["T"], case["causal"], case["H"]))
        # rows alone do not tell an LM's xent from the DBN head's (both
        # 8192 rows): a leg off the LM names its vocabulary
        lm = mcfg.vocab_size
        return sum(leg["launches"][name] for leg in legs
                   if leg["batch"] * leg["seq"] == case["N"]
                   and case.get("V", leg.get("vocab", lm))
                   == leg.get("vocab", lm))
    ffn = {(mcfg.d_model, mcfg.d_ff), (mcfg.d_ff, mcfg.d_model)}
    if name == "int8_matmul":
        per_step = (mcfg.n_layers if (case["K"], case["N"]) in ffn
                    else 1 if case["N"] == mcfg.vocab_size else 0)
        return per_step * sum(r["int8_rows"].get(case["M"], 0)
                              for r in reports)
    if case["Kv"] != mcfg.kv_heads or case["lengths"] != "{}-{}".format(
            *ENGINE_LENGTHS):
        return 0
    pages = PAGED_ROWS[name][1]
    return mcfg.n_layers * sum(r["paged_steps"] for r in reports
                               if r.get("kv_quant") == pages)


#: the paged rows of the kernels line: row name -> (the wrapper whose
#: launches it counts, the kv_quant of the runs it counts them in); #7's
#: one wrapper takes int8 and fp8 pages, and each page type has its row
PAGED_ROWS = {"paged_attention": ("paged_attention", None),
              "paged_attention_int8": ("paged_attention_int8", "int8"),
              "paged_attention_fp8": ("paged_attention_int8", "fp8")}


def row_launches(kname, reports, legs) -> int:
    """A row's launches in the main-path runs: a paged row counts its
    wrapper in the runs on its page type."""
    if kname in PAGED_ROWS:
        wrapper, pages = PAGED_ROWS[kname]
        return sum(r["launches"][wrapper] for r in reports
                   if r.get("kv_quant") == pages)
    return sum(r["launches"][kname] for r in list(reports) + legs)


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
        "paged_attention_fp8": (src + "paged_attention.cu",
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
        launches = row_launches(kname, reports, legs)
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
                   quant: str | None, B=8, fill=128, steps=64):
    """Kernels vs plain versions on one decode state: fill a paged state
    of B rows with ``fill`` positions through the kernel path, then run
    ``steps`` more positions, each once with the kernels and once (on a
    copy of the state) with the plain versions; compare the logits.
    ``quant`` is the pages' ``kv_quant`` mode (None: float pages)."""
    ps = 16
    n_slot = -(-mcfg.max_len // ps)
    P = B * n_slot + 1
    if quant:
        pages = kv_quant.init_quantized_paged_cache(mcfg, P, ps, quant, dev)
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
    (the same weights) on ``quant`` pages (a ``kv_quant`` mode, or None);
    fails the run outside the tolerances."""
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
    from deeplearning4j_tpu_torch.analysis import runtime as rt
    from deeplearning4j_tpu_torch.observability import METRICS

    mcfg = tmodel.cfg
    engine = eng.InferenceEngine(tmodel, params, cfg=scfg, device=dev,
                                 **engine_kw)
    engine.start()                     # builds/loads the kernels, warms up
    reset_counts(wrappers)             # counts of THIS path only
    METRICS.reset()                    # and the registry's (process-wide)
    rt.reset_counts()                  # and the transfer guard's
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new) for p in prompts]
    comps = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in wrappers}
    guard = rt.counts()
    if guard["refused"] or (rt.guard_mode() and not guard["guarded"]):
        fail(f"{label}: the decode segments ran {guard} under the guard")
    for c in comps:
        if len(c.tokens) != max_new or c.finish_reason != "length":
            fail(f"{label}: a request ended {c.finish_reason} with "
                 f"{len(c.tokens)} tokens")
        if any(not 0 <= t < mcfg.vocab_size for t in c.tokens):
            fail(f"{label}: token out of range")
    snap = METRICS.snapshot()
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
              "launches": counts, "config": str(scfg),
              "guard": {"segments": guard["guarded"],
                        "refused": guard["refused"]}}
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
    if "shardguard_violations" in rep:
        extra += (f" guarded_segments={rep['guard']['segments']} "
                  f"refusals={rep['guard']['refused']} shardguard_violations"
                  f"={rep['shardguard_violations']}")
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
#: each with a suffix of 16-64 tokens, 16 new tokens each
PREFIX_SYSTEM, PREFIX_SUFFIX, PREFIX_NEW = 128, (16, 64), 16
#: the uncached baseline engines serve the first 4 of the phase's
#: requests (a request's tokens do not depend on its batch): their
#: token-by-token prefill was ~57 s of the script at 8
PREFIX_BASELINE = 4


def run_prefix(eng, tmodel, params, rng, wrappers, dev="cuda", n_req=16,
               slots=8, page_size=16, system=PREFIX_SYSTEM,
               suffix=PREFIX_SUFFIX, max_new=PREFIX_NEW,
               n_base=PREFIX_BASELINE):
    """The prefix-cache engine on float and on int8 pages against the same
    engine with ``prefix_cache=False`` on the first ``n_base`` of the same
    prompts (a request's tokens do not depend on its batch).  Float pages:
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
            engine, rep = run_engine(eng, tmodel, params, scfg,
                                     prompts if cache else prompts[:n_base],
                                     wrappers, f"prefix {label}", dev=dev,
                                     max_new=max_new)
            engine.stop()
            del engine
            runs[cache] = rep
        hit = runs[True]["prefix"]["prefix_hit_rate"]
        cached = runs[True]["served"][:n_base]
        agree = token_agreement(cached, runs[False]["served"])
        if not hit > 0:
            fail(f"prefix {label}: hit rate {hit}")
        if label == "float" and cached != runs[False]["served"]:
            fail(f"prefix float: tokens differ from prefix_cache=False: "
                 f"{agree}")
        print(engine_line(f"prefix {label} (cache)", runs[True])
              + f" agreement with prefix_cache=False: {agree}", flush=True)
        print(engine_line(f"prefix {label} (no cache)", runs[False]),
              flush=True)
        out[label] = {"cache": runs[True], "no_cache": runs[False],
                      "agreement": agree}
        if label == "int8":
            tf = prefix_teacher_forced(eng, tmodel, params,
                                       prompts[:n_base],
                                       runs[False]["served"], extra, dev=dev,
                                       slots=slots, page_size=page_size)
            out[label]["teacher_forced"] = tf
            print(f"prefix int8 teacher-forced, cache vs no cache: {tf}",
                  flush=True)
            if (tf["top1"] < TOL_TOP1_BF16
                    or not tf["max_err"] <= TOL_LOGITS_BF16
                    or tf["hits"] != n_base - 1):
                fail(f"prefix int8: teacher-forced {tf} (top1 floor "
                     f"{TOL_TOP1_BF16}, logit tol {TOL_LOGITS_BF16}, "
                     f"{n_base - 1} hits)")
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


# ------------------------------------------------------------------ disagg

#: the disaggregated phase's repeat: a prompt of 8 full pages plus the
#: first decode query (16 * 8 + 1 tokens), so its second migration can
#: claim every content page by hash and move no page bytes
DISAGG_REPEAT_PAGES = 8
#: the disaggregated tier serves engine A's first 4 prompts on each page
#: type (8 before phase 15h, ~32 s more; a request's tokens do not
#: depend on its batch)
DISAGG_PROMPTS = 4


def run_disagg(eng, serving, tmodel, params, prompts, want, label, extra,
               wrappers, rng, dev="cuda", max_new=NEW_TOKENS, slots=8,
               page_size=16, expect_launches=True):
    """The disaggregated tier on engine A's serving config (with the prefix
    cache on both tiers, whose chains make a repeat migration hash-only),
    ``extra`` choosing the pages: one ``role="prefill"`` and one
    ``role="decode"`` engine behind ``DisaggScheduler``.

    1. ``prompts`` as concurrent greedy requests through the scheduler:
       the served tokens must equal ``want`` (a unified engine's on the
       same config and prompts) token for token; the pages moved and
       deduped, the bytes moved, the migrations' ms, tokens/s and TTFT,
       and the launches of the run;
    2. a prompt of ``DISAGG_REPEAT_PAGES`` full pages served twice: the
       second migration moves no page bytes and claims every content
       page, with the same tokens;
    3. the repeat prompt migrated over HTTP (``ModelServer`` over the
       scheduler, a prefill on the prefill engine exported with
       ``export_payload`` and imported with ``ServingClient.migrate``):
       once with every content page's bytes on the wire, once as the
       decode side's probe (``ServingClient.migrate_probe``) plans it,
       with no page on the wire; both give the in-process tokens.  (A
       fully cached prompt prefills nothing, so on quantized pages too
       the tokens cannot move with the prefix cache.)

    The whole phase runs with the port's ``LOCKGUARD`` installed (its
    threads: the scheduler's prefill workers, the decode engine's serve
    thread, the HTTP handlers) and the decode engine under Eraser watch
    after ``start()``: the instrumented locks are counted and any
    violation fails the run."""
    from deeplearning4j_tpu_torch.analysis.lockguard import LOCKGUARD
    from deeplearning4j_tpu_torch.observability import METRICS

    mcfg = tmodel.cfg
    common = dict(slots=slots, paged=True, page_size=page_size,
                  int8_decode=True, prefix_cache=True, **extra)
    LOCKGUARD.reset()
    LOCKGUARD.install()                # before the engines build their locks
    made0 = LOCKGUARD.instrumented()
    pf = eng.InferenceEngine(tmodel, params, cfg=eng.ServingConfig(
        role="prefill", **common), device=dev)
    dec = eng.InferenceEngine(tmodel, params, cfg=eng.ServingConfig(
        role="decode", **common), device=dev)
    sched = serving.DisaggScheduler([pf], dec).start()   # warms both
    LOCKGUARD.watch(dec)               # after the start handoff
    try:
        reset_counts(wrappers)
        METRICS.reset()
        t0 = time.perf_counter()
        handles = [sched.submit(p, max_new) for p in prompts]
        comps = [h.result(timeout=900) for h in handles]
        wall = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in wrappers}
        snap = METRICS.snapshot()
        counters, timers = snap["counters"], snap["timers"]
        served = [c.tokens for c in comps]
        if served != want:
            fail(f"disagg {label}: tokens differ from the unified "
                 f"engine's: {token_agreement(served, want)}")
        tokens = sum(len(t) for t in served)
        prefill = (sum(len(p) - 1 for p in prompts)
                   - int(counters.get("serving.prefix_cached_tokens", 0)))
        steps = int(counters.get("serving.decode.dispatches", 0))
        mig = timers["disagg.migrate_seconds"]
        report = {
            "requests": len(prompts), "completed": len(comps),
            "prompt_tokens": sum(len(p) for p in prompts), "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_s": timers["serving.ttft"]["p50_s"],
            "decode_step_p50_s": timers["serving.decode_step"]["p50_s"],
            # the prefill tier's whole call (slot, pages, prefill)
            "prefill_p50_s": timers["serving.prefill_only"]["p50_s"],
            "prefill_steps": prefill, "decode_steps": steps,
            "int8_rows": {1: prefill, slots: steps},
            "paged_steps": steps, "slots": slots,
            "kv_quant": extra.get("kv_quant"),
            "migrations": int(counters.get("disagg.migrations", 0)),
            "pages_moved": int(counters.get("disagg.pages_moved", 0)),
            "pages_deduped": int(counters.get("disagg.pages_deduped", 0)),
            "bytes_moved": int(counters.get("disagg.bytes_moved", 0)),
            "migrate_ms_p50": mig["p50_s"] * 1e3,
            "migrate_ms_mean": mig["mean_s"] * 1e3,
            "migrate_ms_total": mig["total_s"] * 1e3,
            "requeues": int(counters.get("disagg.requeues", 0)),
            "served": served, "launches": counts}
        paged = ("paged_attention_int8" if extra.get("kv_quant")
                 else "paged_attention")
        if expect_launches and (counts["int8_matmul"] <= 0
                                or counts[paged] <= 0):
            fail(f"disagg {label} did not run through its kernels: "
                 f"{counts}")
        if report["migrations"] != len(prompts):
            fail(f"disagg {label}: {report['migrations']} migrations for "
                 f"{len(prompts)} requests")

        # ---- 2. the repeat: hash-only the second time
        rep_prompt = rng.integers(
            0, mcfg.vocab_size, DISAGG_REPEAT_PAGES * page_size + 1).tolist()
        moves = []
        for _ in range(2):
            before = METRICS.snapshot()["counters"]
            c = sched.generate(rep_prompt, 8, timeout=900)
            after = METRICS.snapshot()["counters"]
            moves.append({k: int(after.get(k, 0) - before.get(k, 0))
                          for k in ("disagg.pages_moved",
                                    "disagg.pages_deduped",
                                    "disagg.bytes_moved")}
                         | {"tokens": c.tokens})
        first, second = moves
        if (first["disagg.pages_moved"] != DISAGG_REPEAT_PAGES
                or second["disagg.pages_moved"] != 0
                or second["disagg.bytes_moved"] != 0
                or second["disagg.pages_deduped"] != DISAGG_REPEAT_PAGES
                or second["tokens"] != first["tokens"]):
            fail(f"disagg {label}: the repeat migration is not hash-only: "
                 f"{moves}")
        report["repeat"] = moves

        # ---- 3. the repeat over HTTP: full bytes, then as probed
        with serving.ModelServer(sched) as server:
            client = serving.ServingClient(port=server.port, timeout_s=600)
            probe = client.migrate_probe(rep_prompt)
            http = []
            for cached_len in (0, probe["cached_len"]):
                payload = serving.export_payload(
                    pf, pf.prefill(rep_prompt, 8), cached_len=cached_len)
                out = client.migrate(payload)
                http.append({"cached_len": cached_len,
                             "wire_pages": len(payload["pages"]),
                             "tokens_equal": out["tokens"]
                             == first["tokens"]})
            health = client.healthz()
        if (probe["cached_len"] != DISAGG_REPEAT_PAGES * page_size
                or [h["wire_pages"] for h in http]
                != [DISAGG_REPEAT_PAGES, 0]
                or not all(h["tokens_equal"] for h in http)
                or health["role"] != "disagg"):
            fail(f"disagg {label}: HTTP migrations {http}, probe {probe}, "
                 f"health role {health['role']}")
        report["http"] = http
    finally:
        LOCKGUARD.unwatch(dec)
        sched.stop()
        LOCKGUARD.uninstall()
    report["lockguard"] = {"locks": LOCKGUARD.instrumented() - made0,
                           "violations": len(LOCKGUARD.violations())}
    if LOCKGUARD.violations():
        fail(f"disagg {label}: {LOCKGUARD.report()}")
    print(f"disagg {label}: {report['completed']}/{report['requests']} "
          f"requests, tokens equal the unified engine's, tokens/s="
          f"{report['tokens_per_s']:.1f} ttft_p50_s="
          f"{report['ttft_p50_s']:.4f} decode_step_p50_s="
          f"{report['decode_step_p50_s']:.5f} migrations="
          f"{report['migrations']} pages_moved={report['pages_moved']} "
          f"pages_deduped={report['pages_deduped']} bytes_moved="
          f"{report['bytes_moved']} migrate_ms_p50="
          f"{report['migrate_ms_p50']:.3f} migrate_ms_mean="
          f"{report['migrate_ms_mean']:.3f} repeat={[(m['disagg.pages_moved'], m['disagg.pages_deduped'], m['disagg.bytes_moved']) for m in moves]} "
          f"http={report['http']} launches={counts} lockguard "
          f"{report['lockguard']['locks']} locks instrumented, "
          f"{report['lockguard']['violations']} violations (the numbers "
          f"above taken under it)", flush=True)
    return report


# ------------------------------------------------------------------ router

#: the router phase: 4 tenants x 3 requests (4 before phase 15j), each a
#: tenant's 128-token system prompt, a 16-64-token suffix and 16 new
#: tokens; engine A's serving config with the prefix cache; weights from
#: ROUTER_SEED
ROUTER_TENANTS, ROUTER_PER_TENANT = 4, 3
ROUTER_SYSTEM, ROUTER_SUFFIX, ROUTER_NEW = 128, (16, 64), 16
ROUTER_SEED = 5
ROUTER_SERVING = dict(slots=8, paged=True, page_size=16, int8_decode=True,
                      prefix_cache=True, paged_attention_impl="pallas")
#: the scripted burn sequence the brownout ladder takes, and its levels
BROWNOUT_BURNS = (0.5, 1.5, 2.5, 5.0, 1.5, 0.4, 0.4, 0.2)
BROWNOUT_LEVELS = (0, 1, 2, 3, 2, 1, 0, 0)


def router_model(seed=ROUTER_SEED, device="cuda", **cfg_kw):
    """The router phase's model: the flagship's full width unless
    ``cfg_kw`` narrows it (``dtype`` by name), weights drawn from ``seed``
    on a CPU generator and then placed on ``device``, so that every
    process builds the same."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as ttr

    if "dtype" in cfg_kw:
        cfg_kw["dtype"] = getattr(torch, cfg_kw["dtype"])
    model = ttr.TransformerLM(ttr.TransformerConfig(**cfg_kw), device=device)
    return model, model.init(torch.Generator().manual_seed(seed))


def router_engine(seed=ROUTER_SEED, device="cuda", **cfg_kw):
    """An unstarted engine of the router phase (``ROUTER_SERVING``): the
    ``ProcessReplica`` factory, ``chip_smoke:router_engine``."""
    from deeplearning4j_tpu_torch.serving import engine as eng

    model, params = router_model(seed, device, **cfg_kw)
    return eng.InferenceEngine(model, params,
                               cfg=eng.ServingConfig(**ROUTER_SERVING),
                               device=device)


def _by_tenant(pool, plans, send):
    """Each tenant's requests in order on a thread of its own (so a
    tenant's later requests find its system prompt cached); the answers
    by (tenant, index)."""
    futs = {t: pool.submit(lambda ps=ps, t=t: [send(t, p) for p in ps])
            for t, ps in plans.items()}
    return {(t, i): out for t, f in futs.items()
            for i, out in enumerate(f.result(timeout=1800))}


def run_router(torch, eng, wrappers, card, dev="cuda", cfg_kw=None,
               boot_timeout_s=900.0, expect_launches=True):
    """The prefix-affinity router, observability and the control plane on
    the flagship (``cfg_kw`` narrows it for a CPU rehearsal):

    1. one engine (``ROUTER_SERVING``) serves the phase's 12 requests, 4
       tenants on 4 threads: the single-replica tokens and hit rate;
    2. two ``EngineReplica`` s behind ``PrefixRouter(RouterConfig(
       page_size=16, affinity_pages=4))`` and a ``RouterServer``, the same
       requests through ``ServingClient`` over HTTP, each in a client
       span, a ``TimeSeriesStore`` at 0.1 s with ``SLOEvaluator(
       default_serving_objectives())`` sampling beside them: tokens equal
       the single engine's, each tenant on one replica, the aggregate hit
       rate at least the single replica's, one trace id from the client
       through ``router.request`` / ``router.route`` to the replica's
       ``serving.*`` spans, ``TENANTS`` exactly each tenant's prompt and
       generated tokens, ``serving.decode_mfu`` / ``decode_mbu`` in
       (0, 1]; ``slo.burn_rate.*`` published and read back through a
       ``StatusServer`` scrape and ``parse_prometheus``;
    3. control: ``BROWNOUT_BURNS`` through a ``BrownoutController`` on
       one engine follow ``BROWNOUT_LEVELS`` (the clamp shortens a
       request to a prefix of its tokens; level 3 sheds background work);
       an over-quota tenant gets ``Throttled`` (429) and
       ``tenant.<t>.throttled``; ``Autoscaler.step`` over
       ``router_actuators`` scales up by one warmed ``EngineReplica`` on a
       forced burn and back down after two quiet windows;
    4. a ``ProcessReplica`` of the same engine joins through
       ``router.scale_up``: its tokens equal the in-process ones,
       ``FleetScraper`` federates its ``/metrics.prom``; after ``kill()``
       a key it owned spills or answers 503 within the client timeout,
       and its quarantine leaves a flight-recorder bundle naming it."""
    import concurrent.futures as cf
    import shutil
    import tempfile
    import urllib.request

    import numpy as np

    from deeplearning4j_tpu_torch import observability as tobs
    from deeplearning4j_tpu_torch.control import (Autoscaler,
                                                  AutoscalerConfig,
                                                  BrownoutConfig,
                                                  BrownoutController,
                                                  ControlSignals,
                                                  OverloadGate, Throttled,
                                                  TokenBucketAdmission)
    from deeplearning4j_tpu_torch.control.autoscaler import router_actuators
    from deeplearning4j_tpu_torch.control.overload import BucketConfig
    from deeplearning4j_tpu_torch.serving import (EngineReplica,
                                                  PrefixRouter,
                                                  ProcessReplica,
                                                  RouterConfig, RouterServer,
                                                  ServingClient, ServingError)

    t_phase = time.perf_counter()
    cfg_kw = dict(cfg_kw or {})
    rng = np.random.default_rng(ROUTER_SEED)
    model, params = router_model(ROUTER_SEED, dev, **dict(cfg_kw))
    vocab = model.cfg.vocab_size
    scfg = eng.ServingConfig(**ROUTER_SERVING)
    tenants = [f"tenant{i}" for i in range(ROUTER_TENANTS)]
    heads = {t: rng.integers(0, vocab, ROUTER_SYSTEM).tolist()
             for t in tenants}
    plans = {t: [heads[t] + rng.integers(0, vocab, int(rng.integers(
        ROUTER_SUFFIX[0], ROUTER_SUFFIX[1] + 1))).tolist()
        for _ in range(ROUTER_PER_TENANT)] for t in tenants}
    n_req = ROUTER_TENANTS * ROUTER_PER_TENANT
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_router-"))
    old_dump = tobs.FLIGHTREC.dump_dir
    tobs.FLIGHTREC.dump_dir = work / "flightrec"
    pool = cf.ThreadPoolExecutor(max_workers=ROUTER_TENANTS)
    timings = {}

    def make_engine():
        t0 = time.perf_counter()
        e = eng.InferenceEngine(model, params, cfg=scfg, device=dev)
        e.start()
        timings.setdefault("engine_start_s", []).append(
            time.perf_counter() - t0)
        return e

    try:
        # ---- 1. one replica: the tokens and the hit rate to match
        single = make_engine()
        t0 = time.perf_counter()
        base = _by_tenant(pool, plans, lambda t, p: single.generate(
            p, ROUTER_NEW, tenant=t, timeout=900).tokens)
        single_s = time.perf_counter() - t0
        single_hit = single.stats()["prefix_hit_rate"]
        single.stop()
        del single

        # ---- 2. two replicas behind the router, over HTTP
        engines = [make_engine() for _ in range(2)]
        reps = [EngineReplica(f"r{i}", e, own_engine=True)
                for i, e in enumerate(engines)]
        # requests wait on the host-bound prefill of the others: a
        # timeout of 600 s, not the default 60, so no slow answer is
        # taken for a dead replica
        router = PrefixRouter(reps, RouterConfig(page_size=16,
                                                 affinity_pages=4,
                                                 request_timeout_s=600.0))
        tobs.METRICS.reset()
        tobs.TENANTS.reset()
        tobs.TRACER.clear()
        store = tobs.TimeSeriesStore(interval_s=0.1)
        slo = tobs.SLOEvaluator(tobs.default_serving_objectives(), store)
        server = RouterServer(router).start()
        client = ServingClient(port=server.port, timeout_s=900)
        store.start()

        def send(t, p):
            with tobs.trace.span("client.generate", tenant=t) as sp:
                out = client.generate(p, ROUTER_NEW, tenant=t)
            out["trace_id"] = sp.trace_id
            return out

        reset_counts(wrappers)
        t0 = time.perf_counter()
        served = _by_tenant(pool, plans, send)
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        time.sleep(0.35)                  # a few more samples, then stop
        store.stop()
        router.pool.probe_once()
        snap = tobs.METRICS.snapshot()
        counters, gauges, timers = (snap["counters"], snap["gauges"],
                                    snap["timers"])
        bad = [k for k in base if served[k]["tokens"] != base[k]]
        if bad:
            fail(f"router: tokens differ from one engine's for {bad}")
        homes = {t: {served[(t, i)]["replica"]
                     for i in range(ROUTER_PER_TENANT)} for t in tenants}
        spills = int(counters.get("router.spillover", 0))
        if any(len(h) != 1 for h in homes.values()) or spills:
            fail(f"router: tenants spread over replicas {homes}, "
                 f"{spills} spills")
        hit = gauges["router.prefix_hit_rate"]
        if not hit >= single_hit:
            fail(f"router: aggregate prefix hit rate {hit} below one "
                 f"replica's {single_hit}")
        want_spans = {"client.generate", "router.request", "router.route",
                      "serving.queue_wait", "serving.prefill",
                      "serving.decode.segment", "serving.emit",
                      "serving.request"}
        events = tobs.TRACER.to_chrome_trace()["traceEvents"]
        by_trace = {}
        for ev in events:
            tid = (ev.get("args") or {}).get("trace_id")
            by_trace.setdefault(tid, set()).add(ev["name"])
        short = {k: sorted(want_spans - by_trace.get(o["trace_id"], set()))
                 for k, o in served.items()
                 if not want_spans <= by_trace.get(o["trace_id"], set())}
        if short:
            fail(f"router: requests missing spans under their trace id: "
                 f"{short}")
        accounts = {t: (counters.get(f"tenant.{t}.prompt_tokens"),
                        counters.get(f"tenant.{t}.generated_tokens"))
                    for t in tenants}
        want_accounts = {t: (float(sum(len(p) for p in plans[t])),
                             float(ROUTER_PER_TENANT * ROUTER_NEW))
                         for t in tenants}
        if accounts != want_accounts:
            fail(f"router: tenant accounts {accounts}, the requests "
                 f"{want_accounts}")
        mfu, mbu = (gauges.get("serving.decode_mfu"),
                    gauges.get("serving.decode_mbu"))
        if not (mfu is not None and mbu is not None and 0 < mfu <= 1
                and 0 < mbu <= 1):
            fail(f"router: serving.decode_mfu {mfu} / decode_mbu {mbu} not "
                 "both in (0, 1]")
        burns = {k: v for k, v in gauges.items()
                 if k.startswith("slo.burn_rate.")}
        status = tobs.StatusServer().start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{status.port}/metrics.prom",
                    timeout=30) as r:
                scraped = tobs.parse_prometheus(r.read().decode())
        finally:
            status.stop()
        read_back = {k: v for k, v in scraped["gauges"].items()
                     if k.startswith("slo_burn_rate_")}
        if len(burns) != 3 or len(read_back) != 3 \
                or store.stats()["samples"] < 3:
            fail(f"slo: burn rates {burns}, scraped {read_back}, samples "
                 f"{store.stats()}")
        prefill = (sum(len(p) - 1 for ps in plans.values() for p in ps)
                   - int(counters.get("serving.prefix_cached_tokens", 0)))
        steps = int(counters["serving.decode.dispatches"])
        if expect_launches and (launches["int8_matmul"] <= 0
                                or launches["paged_attention"] <= 0):
            fail(f"router: the replicas did not run through their kernels: "
                 f"{launches}")
        tokens = sum(len(o["tokens"]) for o in served.values())
        report = {
            "requests": n_req, "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "ttft_p50_s": timers["serving.ttft"]["p50_s"],
            "decode_step_p50_s": timers["serving.decode_step"]["p50_s"],
            "single_replica_wall_s": single_s,
            "prefix_hit_rate": hit, "single_replica_hit_rate": single_hit,
            "homes": {t: sorted(h) for t, h in homes.items()},
            "spills": spills, "decode_mfu": mfu, "decode_mbu": mbu,
            "slo_burn_rates": burns, "slo_scraped": read_back,
            "tenant_accounts": accounts,
            "int8_rows": {1: prefill, scfg.slots: steps},
            "paged_steps": steps, "kv_quant": None, "launches": launches}

        # ---- 3. control: the brownout ladder on engine r0
        clock = [0.0]
        bc = BrownoutController(engines[0], BrownoutConfig(
            dwell_s=1.0, clamp_max_new=ROUTER_NEW // 2),
            clock=lambda: clock[0])
        levels, capped, shed = [], None, None
        probe_key = next(k for k in base if served[k]["replica"] == "r0")
        probe = plans[probe_key[0]][probe_key[1]]
        for b in BROWNOUT_BURNS:
            clock[0] += 1.0
            levels.append(bc.update(b))
            stats = engines[0].stats()
            if levels[-1] == 2 and capped is None:
                if stats["max_new_cap"] != ROUTER_NEW // 2:
                    fail(f"brownout level 2: cap {stats['max_new_cap']}")
                capped = engines[0].generate(probe, ROUTER_NEW,
                                             timeout=900).tokens
            if levels[-1] == 3 and shed is None:
                gate = OverloadGate(brownout=bc).install(engines[0])
                try:
                    engines[0].submit(probe, 4, priority=1)
                    shed = False
                except Throttled as e:
                    shed = e.status == 429
                engines[0].set_admission_hook(None)
                del gate
        final_cap = engines[0].stats()["max_new_cap"]
        if tuple(levels) != BROWNOUT_LEVELS or capped != base[probe_key][
                :ROUTER_NEW // 2] or not shed or final_cap is not None:
            fail(f"brownout: levels {levels} (want {BROWNOUT_LEVELS}), "
                 f"clamped tokens {capped}, background shed {shed}, final "
                 f"cap {final_cap}")

        # ---- an over-quota tenant
        OverloadGate(bucket=TokenBucketAdmission(BucketConfig(
            rate_tokens_s=1.0, burst_tokens=1.5 * ROUTER_NEW))).install(
                engines[0])
        first = engines[0].submit(probe, ROUTER_NEW, tenant="noisy")
        try:
            engines[0].submit(probe, ROUTER_NEW, tenant="noisy")
            throttled = None
        except Throttled as e:
            throttled = e.status
        engines[0].set_admission_hook(None)
        first.result(timeout=900)
        n_throttled = tobs.METRICS.snapshot()["counters"].get(
            "tenant.noisy.throttled")
        if throttled != 429 or n_throttled != 1:
            fail(f"fair share: the over-quota tenant got {throttled}, "
                 f"tenant.noisy.throttled={n_throttled}")

        # ---- the autoscaler over the router's actuators
        seq = [len(engines)]
        built = {}

        def factory():
            name = f"r{seq[0]}"
            seq[0] += 1
            t0 = time.perf_counter()
            built[name] = EngineReplica(name, make_engine(), own_engine=True)
            timings["scale_up_build_s"] = time.perf_counter() - t0
            return built[name]

        acfg = AutoscalerConfig(cooldown_s=0.0, down_consecutive=2,
                                max_replicas=4, warm_timeout_s=900.0,
                                drain_timeout_s=120.0)
        up, down, size = router_actuators(router, factory, acfg)
        feed = [ControlSignals(burn=2.0), ControlSignals(burn=0.1),
                ControlSignals(burn=0.1)]
        aclock = [0.0]
        scaler = Autoscaler(lambda: feed.pop(0), up, down, size, cfg=acfg,
                            clock=lambda: aclock[0])
        decisions, sizes = [], []
        t0 = time.perf_counter()
        for _ in range(3):
            aclock[0] += 1.0
            decisions.append(scaler.step())
            sizes.append(size())
            if decisions[-1] == "up":
                timings["scale_up_s"] = time.perf_counter() - t0
                new = router.pool.names()[-1]
                out = router.generate(probe, ROUTER_NEW)
                timings["scale_up_probe_replica"] = out["replica"]
                if new not in set(router.ring.walk("any")):
                    fail(f"autoscaler: {new} is not on the ring")
        if decisions != ["up", None, "down"] or sizes != [3, 3, 2]:
            fail(f"autoscaler: decisions {decisions}, pool sizes {sizes}")

        # ---- 4. a process replica joins the ring, then dies
        t0 = time.perf_counter()
        rep = ProcessReplica("p0", "chip_smoke:router_engine", work,
                             factory_kwargs={"seed": ROUTER_SEED,
                                             "device": dev, **cfg_kw},
                             boot_timeout_s=boot_timeout_s,
                             client_timeout_s=300.0)
        boot_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        router.scale_up(rep, warm_timeout_s=boot_timeout_s)
        admit_s = time.perf_counter() - t0
        firsts = [(t, 0) for t in tenants]
        direct = {k: rep.generate({"prompt": plans[k[0]][k[1]],
                                   "max_new_tokens": ROUTER_NEW,
                                   "tenant": k[0]}, 900)["tokens"]
                  for k in firsts}
        if any(direct[k] != base[k] for k in firsts):
            fail(f"process replica: tokens differ from the in-process "
                 f"replicas' for {[k for k in firsts if direct[k] != base[k]]}")
        scraper = tobs.FleetScraper(router.pool, timeout_s=30.0)
        federated = scraper.scrape_once()
        p0_requests = scraper.fed.value("serving.requests", "p0")
        if federated != 1 or p0_requests != len(firsts):
            fail(f"fleet: {federated} replicas federated, p0 requests "
                 f"{p0_requests}")
        fleet_tokens = tobs.METRICS.snapshot()["gauges"][
            "fleet.tokens_total"]
        owned = None
        for _ in range(10_000):
            cand = rng.integers(0, vocab, ROUTER_SYSTEM + 8).tolist()
            if router.route_order(router.routing_key(cand))[0] == "p0":
                owned = cand
                break
        if owned is None:
            fail("no key of 10,000 lands on p0")
        rep.kill()
        t0 = time.perf_counter()
        try:
            after_kill = client.generate(owned, 4)
            outcome = f"spilled to {after_kill['replica']} " \
                      f"({after_kill['spills']} spills)"
            ok = after_kill["replica"] != "p0" and after_kill["spills"] >= 1
        except ServingError as e:
            outcome, ok = f"HTTP {e.status}", e.status == 503
        kill_s = time.perf_counter() - t0
        deadline = time.monotonic() + 30.0
        while router.pool.is_active("p0") and time.monotonic() < deadline:
            time.sleep(0.05)
        bundles = [json.loads(b.read_text()) for b in sorted(
            tobs.FLIGHTREC.dump_dir.glob(
                "flightrec-router_replica_quarantine-*.json"))]
        named = any(b["extra"]["replica"] == "p0" for b in bundles)
        if not (ok and kill_s < 300.0 and not router.pool.is_active("p0")
                and named):
            fail(f"after kill: {outcome} in {kill_s:.2f} s, p0 active "
                 f"{router.pool.is_active('p0')}, bundle naming p0 {named}")
        quarantines = int(tobs.METRICS.snapshot()["counters"].get(
            "router.quarantines", 0))
        server.stop()
        report.update({
            "brownout_levels": levels, "scale_decisions": decisions,
            "engine_start_s": timings["engine_start_s"],
            "scale_up_s": timings["scale_up_s"],
            "scale_up_build_s": timings["scale_up_build_s"],
            "process_boot_s": boot_s, "process_admit_s": admit_s,
            "fleet_tokens_total": fleet_tokens,
            "after_kill": outcome, "after_kill_s": kill_s,
            "quarantines": quarantines,
            "phase_s": time.perf_counter() - t_phase})
        print(f"router: {card} | {n_req} requests of {ROUTER_TENANTS} "
              f"tenants over HTTP through 2 replicas: tokens/s="
              f"{report['tokens_per_s']:.2f} ttft_p50_s="
              f"{report['ttft_p50_s']:.4f} decode_step_p50_s="
              f"{report['decode_step_p50_s']:.5f} hit rate {hit:.4f} (one "
              f"replica {single_hit:.4f}) homes {report['homes']} spills="
              f"{spills} decode_mfu={mfu:.6f} decode_mbu={mbu:.6f} "
              f"slo={ {k[14:]: round(v, 4) for k, v in burns.items()} } "
              f"brownout {levels} autoscaler {decisions} (scale-up "
              f"{timings['scale_up_s']:.2f} s, its engine warm "
              f"{timings['scale_up_build_s']:.2f} s) process replica boot "
              f"{boot_s:.2f} s, admitted in {admit_s:.3f} s, tokens equal; "
              f"after kill: {outcome} in {kill_s:.3f} s, quarantines="
              f"{quarantines}; the phase {report['phase_s']:.1f} s; "
              f"launches={launches}", flush=True)
        return report
    finally:
        pool.shutdown(wait=False)
        tobs.FLIGHTREC.dump_dir = old_dump
        shutil.rmtree(work, ignore_errors=True)


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

    from deeplearning4j_tpu_torch.observability import METRICS

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
        before = METRICS.snapshot()["timers"]["serving.score_batch"]
        reset_counts(wrappers)
        t0 = time.perf_counter()
        served = np.asarray(client.score(data), np.float32)
        wall = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in wrappers}
        after = METRICS.snapshot()["timers"]["serving.score_batch"]
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


#: the trainer's live train.mfu against this script's MFU (relative)
TOL_TRAIN_MFU = 0.10

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


def train_mfu_check(torch, cfg, trainer, mfus, step_p50, tokens, dev):
    """The trainer's live ``train.mfu`` (its step counted by
    ``COSTS.capture`` on fake tensors, over each step's own time) against
    this script's MFU for the same step: ``flops_per_token`` x tokens over
    the p50 step time and the card's bf16 peak.  The gauge of the p50 step
    is the p50 of the gauges (one step a window, so the gauge falls as
    the time rises); the two must agree within ``TOL_TRAIN_MFU``."""
    from deeplearning4j_tpu_torch.observability import COSTS

    cost = trainer._step_cost
    if cost is None or len(mfus) < 2:
        fail(f"train.mfu: no counted step cost ({cost}) or gauges {mfus}")
    n = len(mfus)
    gauge = sorted(mfus, reverse=True)[min(n - 1, int(round(0.5 * (n - 1))))]
    peak = (rates_for(torch.cuda.get_device_name(0))[1] if dev == "cuda"
            else COSTS.peak_flops())
    script = cfg.flops_per_token() * tokens / step_p50 / peak
    rel = gauge / script - 1.0
    out = {"train_mfu": gauge, "script_mfu": script, "rel": rel,
           "counted_flops": cost.flops, "counted_bytes": cost.bytes_accessed,
           "source": cost.source,
           "flops_per_token_x_tokens": cfg.flops_per_token() * tokens,
           "gauges": mfus}
    print(f"train.mfu {gauge:.5f} (counted {cost.flops:.4e} flops, "
          f"{cost.bytes_accessed:.4e} bytes a step) vs the script's "
          f"{script:.5f} (flops_per_token x {tokens} tokens = "
          f"{cfg.flops_per_token() * tokens:.4e}): {rel * 100:+.2f}% "
          f"(tol {TOL_TRAIN_MFU * 100:.0f}%)", flush=True)
    if not (0 < gauge <= 1 and abs(rel) <= TOL_TRAIN_MFU):
        fail(f"train.mfu {gauge} vs the script's MFU {script}: {out}")
    return out


def _serve_wave(client, prompts, new, pool):
    """Greedy requests over HTTP, concurrently; the answers in order."""
    futs = [pool.submit(client.generate, p, max_new_tokens=new)
            for p in prompts]
    return [f.result(timeout=900) for f in futs]


def _engine_deltas(before):
    """Prefill tokens and decode dispatches since the ``before`` snapshot
    of the process-wide registry's counters."""
    from deeplearning4j_tpu_torch.observability import METRICS

    now = METRICS.snapshot()["counters"]
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

        # ---- fault-free run: one resolve a step, for the step times; the
        # trainer's train.mfu gauge of every step is kept
        tobs.METRICS.reset()
        mfus, listening = [], [True]
        tobs.METRICS.add_listener(
            lambda kind, name, v: mfus.append(v)
            if listening[0] and name == "train.mfu" else None)
        ref_tr = make_trainer()
        ref, ref_losses = ref_tr.fit(ref_tr.init_state(params, key=0),
                                     data[:CKPT_STEPS], async_dispatch=False)
        listening[0] = False
        step_p50 = tobs.METRICS.snapshot()["timers"]["train_step.execute"][
            "p50_s"]
        if not all(math.isfinite(v) for v in ref_losses) or abs(
                ref_losses[0] - math.log(cfg.vocab_size)) > 0.5:
            fail(f"checkpoint phase: fault-free losses {ref_losses}")
        mfu = train_mfu_check(torch, cfg, ref_tr, mfus, step_p50,
                              batch * seq, dev)
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
            "train_mfu": mfu,
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
            before = dict(tobs.METRICS.snapshot()["counters"])
            reset_counts(wrappers)
            t0 = time.perf_counter()
            wave0 = _serve_wave(client, prompts, RELOAD_NEW, pool)
            serve_s = time.perf_counter() - t0
            serve_launches = {w.__name__: w.launches for w in wrappers}
            d0 = _engine_deltas(before)
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
            before = dict(tobs.METRICS.snapshot()["counters"])
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
            d1 = _engine_deltas(before)
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


# ------------------------------------------------------------------ online

#: the online phase: requests served over HTTP into the capture store,
#: then synthetic records of ONLINE_RECORD tokens filling ONLINE_STEPS
#: training batches of the checkpoint phase's size (8 x 512), and one
#: more batch for the poisoned round
ONLINE_REQUESTS, ONLINE_NEW = 4, 16
ONLINE_RECORD = 513
ONLINE_STEPS = 2


def run_online(torch, ttr, eng, wrappers, rng, dev="cuda", cfg=None,
               batch=CKPT_BATCH, seq=CKPT_SEQ, expect_launches=True):
    """The online loop on ``cfg`` (the checkpoint phase's config by
    default), in a temporary directory removed at the end:

    1. ``ModelServer(capture=CaptureStore)`` over an engine on a
       ``CheckpointManager`` (engine A's serving config) answers
       ``ONLINE_REQUESTS`` greedy requests over HTTP; each lands in the
       store;
    2. records of synthetic traffic fill ``ONLINE_STEPS`` batches of
       ``batch`` x ``seq``; ``OnlineLoop.run_once`` publishes the step-0
       bootstrap, fine-tunes ``ONLINE_STEPS`` steps (sgd, one checkpoint a
       step), canaries the published bytes and hot-reloads the engine:
       status "ok", ``loaded_step`` = ``ONLINE_STEPS``, and a request
       served after it carries that step;
    3. one more batch of records and a round with ``online.publish``
       poisoning the published step: the canary finds it non-finite, the
       step is quarantined and the engine rolls back to the step before,
       with a flight-recorder bundle."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch import observability as tobs
    from deeplearning4j_tpu_torch.online import (CaptureStore, OnlineConfig,
                                                 OnlineLoop)
    from deeplearning4j_tpu_torch.parallel import CheckpointManager
    from deeplearning4j_tpu_torch.resilience import FaultSpec, inject_faults
    from deeplearning4j_tpu_torch.serving import ModelServer, ServingClient

    cfg = cfg or ttr.TransformerConfig(attention="fused", fused_ln=True,
                                       xent_impl="blocked")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_online-"))
    old_dump = tobs.FLIGHTREC.dump_dir
    tobs.FLIGHTREC.dump_dir = work / "flightrec"
    engine = None
    try:
        model = ttr.TransformerLM(cfg, device=dev)
        params0 = model.init(torch.Generator(device=dev).manual_seed(3))
        store = CaptureStore(work / "capture")
        mgr = CheckpointManager(work / "ckpt", keep=8)
        engine = eng.InferenceEngine(
            model, params0, mgr, eng.ServingConfig(
                slots=8, paged=True, page_size=16, int8_decode=True,
                paged_attention_impl="pallas"), device=dev).start()
        reset_counts(wrappers)
        tobs.METRICS.reset()
        t0 = time.perf_counter()
        prompts = make_prompts(rng, ONLINE_REQUESTS, cfg.vocab_size,
                               (16, 32))
        with ModelServer(engine, capture=store) as server:
            client = ServingClient(port=server.port, timeout_s=600)
            served = [client.generate(p, max_new_tokens=ONLINE_NEW)
                      for p in prompts]
        serve_s = time.perf_counter() - t0

        def take():
            """This path's launches since the last take (then from 0)."""
            out = {w.__name__: w.launches for w in wrappers}
            reset_counts(wrappers)
            return out

        def add(a, b):
            return {k: a[k] + b[k] for k in a}

        serve_counts = take()
        if len(store.records()) != len(prompts) or any(
                a["loaded_step"] is not None for a in served):
            fail(f"online: {len(store.records())} captured records for "
                 f"{len(prompts)} requests, stamps "
                 f"{[a['loaded_step'] for a in served]}")

        def traffic(n):
            for _ in range(n):
                toks = rng.integers(0, cfg.vocab_size, ONLINE_RECORD)
                store.append({"prompt": toks[:16].tolist(),
                              "tokens": toks[16:].tolist()})

        # records fill ONLINE_STEPS batches, the served ones included
        block = seq + 1
        traffic(-(-(ONLINE_STEPS * batch * block)
                  // ONLINE_RECORD))
        loop = OnlineLoop(store, mgr, model, params0=params0, engine=engine,
                          cfg=OnlineConfig(batch=batch, seq=seq))
        t0 = time.perf_counter()
        rep1 = loop.run_once().to_dict()
        round_s = time.perf_counter() - t0
        round_counts = take()
        gauges = tobs.METRICS.snapshot()["gauges"]
        canary, reload_s = (gauges.get("online.canary_loss"),
                            gauges.get("online.reload_seconds"))
        with ModelServer(engine, capture=store) as server:
            client = ServingClient(port=server.port, timeout_s=600)
            after = client.generate(prompts[0], max_new_tokens=ONLINE_NEW)
        serve_counts = add(serve_counts, take())
        trained = rep1["trained_to"]
        if (rep1["status"] != "ok" or trained < ONLINE_STEPS
                or engine.stats()["loaded_step"] != trained
                or after["loaded_step"] != trained
                or after["generation"] != 1):
            fail(f"online round: {rep1}, engine at "
                 f"{engine.stats()['loaded_step']}, a request after it "
                 f"stamped {after['generation']}/{after['loaded_step']}")

        # ---- the poisoned round rolls back
        traffic(-(-(batch * block) // ONLINE_RECORD))
        t0 = time.perf_counter()
        with inject_faults(FaultSpec("online.publish", at_step=1,
                                     kind="poison"), seed=0):
            rep2 = loop.run_once().to_dict()
        rollback_s = time.perf_counter() - t0
        # the rounds: the fine-tune steps and the canaries, at batch x seq
        leg = {"batch": batch, "seq": seq, "causal": cfg.causal,
               "launches": add(round_counts, take())}
        # the serving: the requests before the first round and after it
        steps = int(tobs.METRICS.snapshot()["counters"].get(
            "serving.decode.dispatches", 0))
        prefill = sum(len(p) - 1 for p in prompts) + len(prompts[0]) - 1
        serve = {"requests": len(prompts) + 1, "wall_s": serve_s,
                 "int8_rows": {1: prefill, 8: steps}, "paged_steps": steps,
                 "kv_quant": None, "launches": serve_counts}
        bundles = sorted((work / "flightrec").glob(
            "flightrec-online_rollback-*"))
        # checkpoint_every=1: the step before the poisoned one is valid
        back = rep2["trained_to"] - 1
        if (rep2["status"] != "rolled_back"
                or rep2["rollback_reason"] != "canary_nonfinite"
                or back < trained or engine.stats()["loaded_step"] != back
                or mgr.latest_valid_step() != back or not bundles):
            fail(f"online poisoned round: {rep2}, engine at "
                 f"{engine.stats()['loaded_step']}, bundles {bundles}")
        if expect_launches and (
                serve["launches"]["paged_attention"] <= 0
                or leg["launches"]["fused_attention"] <= 0
                or leg["launches"]["blocked_cross_entropy"] <= 0):
            fail(f"online: kernels not launched: serve {serve['launches']}"
                 f" rounds {leg['launches']}")
        out = {"serve": serve, "leg": leg, "records": len(store.records()),
               "round": rep1, "round_s": round_s, "poisoned": rep2,
               "rollback_round_s": rollback_s, "canary_loss": canary,
               "reload_s": reload_s,
               "after": {k: after[k] for k in ("generation", "loaded_step")}}
    finally:
        if engine is not None:
            engine.stop()
        tobs.FLIGHTREC.dump_dir = old_dump
        shutil.rmtree(work, ignore_errors=True)
    print(f"online: {ONLINE_REQUESTS} requests served and captured in "
          f"{serve_s:.3f} s; round {rep1['status']} trained to step "
          f"{trained} and reloaded in {round_s:.3f} s (canary loss "
          f"{out['canary_loss']}, reload {out['reload_s']} s); a request "
          f"after it stamped {out['after']}; the poisoned round "
          f"{rep2['status']} ({rep2['rollback_reason']}, back on step "
          f"{back}) in {rollback_s:.3f} s; records {out['records']}; "
          f"launches serve {serve['launches']} rounds {leg['launches']}",
          flush=True)
    return out


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


# ------------------------------------------------------------------ DL4J

def write_mnist(np, mnist_idx, root: Path, n=DL4J_IMAGES, seed=0):
    """Seeded MNIST-shaped IDX files in ``root``: uniform uint8 pixels,
    labels from a fixed linear teacher on the centred binarized pixels
    (learnable, and balanced over the 10 classes)."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    bits = (imgs.reshape(n, -1) > 127).astype(np.float32) - 0.5
    labels = np.argmax(bits @ rng.standard_normal((784, 10)).astype(
        np.float32), 1).astype(np.uint8)
    root.mkdir(parents=True, exist_ok=True)
    mnist_idx.write_idx_images(root / "train-images-idx3-ubyte", imgs)
    mnist_idx.write_idx_labels(root / "train-labels-idx1-ubyte", labels)


def cli_stats(out: str) -> tuple[str, float]:
    """The ``Evaluation.stats()`` block a CLI printed, and its F1."""
    lines = out.splitlines()
    start = lines.index(
        "==========================Scores==========================")
    block = [l for l in lines[start:] if not l.startswith("model saved")]
    f1 = float(next(l for l in block if "F1 Score" in l).split()[-1])
    return "\n".join(block), f1


def params_err(torch, got, want) -> tuple[float, float]:
    """Over the leaves, the max of max |got - want| / max |want| and the
    max of ||got - want|| / ||want||."""
    pairs = [(g[k].cpu(), w[k]) for g, w in zip(got, want) for k in w]
    return (max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in pairs),
            max((torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b)).item() for a, b in pairs))


def score64(torch, net, ds) -> float:
    """The supervised loss of ``net``'s parameters on ``ds``, in float64
    on the CPU."""
    from deeplearning4j_tpu_torch.ops import dtypes

    old = dtypes.get_policy()
    dtypes.set_policy(torch.float64, torch.float64)
    try:
        params = tuple({k: v.detach().cpu().double() for k, v in p.items()}
                       for p in net.params)
        with torch.no_grad():
            return float(net.supervised_loss(
                params, torch.from_numpy(ds.features).double(),
                torch.from_numpy(ds.labels).double()))
    finally:
        dtypes.set_policy(old.param_dtype, old.compute_dtype)


def card_vs_cpu(torch, build, ds, label, hooks=None, tol=TOL_DL4J,
                hold=True, keep=None, dev="cuda"):
    """``build(device)`` fit on the CPU and on the card from the same
    starting parameters (a CPU generator seeded 0): the parameters must
    agree within ``tol`` and the float64 loss of each side's final
    parameters within ``TOL_DL4J``.  ``hooks`` wraps the card's fit;
    ``hold=False`` reports the comparison without holding it; ``keep``,
    a dict, receives the two fitted networks by device."""
    nets = {}
    for d in ("cpu", dev):
        net = build(d)
        net.init(0)
        nets[d] = net
    nets["cpu"].fit(ds)
    t0 = time.perf_counter()
    with (hooks() if hooks else contextlib.nullcontext()):
        nets[dev].fit(ds)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    err, norm_err = params_err(torch, nets[dev].params,
                               nets["cpu"].params)
    s_card, s_cpu = (score64(torch, nets[d], ds) for d in (dev, "cpu"))
    serr = abs(s_card - s_cpu) / abs(s_cpu)
    f32 = {d: nets[d].score() for d in (dev, "cpu")}
    rep = {"params_rel_err": err, "params_norm_rel_err": norm_err,
           "tol": tol if hold else None, "score64_rel_err": serr,
           "score64": s_cpu, "score_f32": f32,
           "score_f32_rel_err": abs(f32[dev] - f32["cpu"])
           / abs(f32["cpu"]), "card_fit_s": card_s}
    print(f"dl4j {label}: card vs CPU {json.dumps(rep)}", flush=True)
    if keep is not None:
        keep.update(nets)
    if not all(torch_isfinite(v) for n in nets.values() for p in n.params
               for v in p.values()):
        fail(f"dl4j {label}: a fit's parameters are not finite")
    if hold and not (err < tol and serr < TOL_DL4J):
        fail(f"dl4j {label}: card vs CPU params {err:.3g} (tol {tol}), "
             f"score {serr:.3g} (tol {TOL_DL4J})")
    return rep


def first_order_card_vs_cpu(torch, build, ds, label, dev="cuda"):
    """A first-order AdaGrad fit on the card against the CPU, held as
    the comment above ``TOL_DL4J`` sets out: the float32 loss and every
    gradient leaf at the fit's starting parameters, the whole fit in
    float64 (``card_vs_cpu``), and the float32 fit (reported) with the
    card's output at the CPU's final parameters, each within
    ``TOL_DL4J``."""
    from deeplearning4j_tpu_torch.ops import dtypes
    from deeplearning4j_tpu_torch.utils import tree_math as tm
    from deeplearning4j_tpu_torch.utils.autodiff import value_and_grad

    nets = {d: build(d) for d in ("cpu", dev)}
    got = {}
    for d, net in nets.items():
        net.init(0)
        got[d] = value_and_grad(net.supervised_loss)(
            net.params, net._tensor(ds.features), net._tensor(ds.labels))
    loss_err = abs(got[dev][0].item() - got["cpu"][0].item()) \
        / abs(got["cpu"][0].item())
    grad_err = params_err(torch, got[dev][1], got["cpu"][1])[0]
    rep = {"float32_start": {"loss_rel_err": loss_err,
                             "grads_rel_err": grad_err, "tol": TOL_DL4J}}
    print(f"dl4j {label}: float32 loss and gradients at the start, card vs "
          f"CPU {json.dumps(rep['float32_start'])}", flush=True)
    if not (loss_err < TOL_DL4J and grad_err < TOL_DL4J):
        fail(f"dl4j {label}: float32 loss {loss_err:.3g} or gradients "
             f"{grad_err:.3g} differ card vs CPU (tol {TOL_DL4J})")
    old = dtypes.get_policy()
    dtypes.set_policy(torch.float64, torch.float64)
    try:
        rep["float64_fit"] = card_vs_cpu(torch, build, ds,
                                         f"{label} float64", dev=dev)
    finally:
        dtypes.set_policy(old.param_dtype, old.compute_dtype)
    rep["float32_fit"] = card_vs_cpu(torch, build, ds, label, hold=False,
                                     keep=nets, dev=dev)
    nets[dev].params = tm.tree_map(lambda a: a.to(dev), nets["cpu"].params)
    out, want = nets[dev].output(ds.features), nets["cpu"].output(ds.features)
    out_err = ((out.cpu() - want).abs().max() / want.abs().max()).item()
    rep["float32_fit"]["output_at_cpu_params_rel_err"] = out_err
    print(f"dl4j {label}: float32 output at the CPU fit's parameters, card "
          f"vs CPU {out_err:.3g} (tol {TOL_DL4J})", flush=True)
    if not out_err < TOL_DL4J:
        fail(f"dl4j {label}: the float32 output at the CPU fit's parameters "
             f"differs card vs CPU by {out_err:.3g} (tol {TOL_DL4J})")
    return rep


def run_dl4j(torch, txe, wrappers, rates, cases, card: str):
    """The DL4J network stack on the card (the README's first entry
    point): the CLI's ``train --model dbn --dataset mnist --batch 8192``
    and ``evaluate`` as subprocesses on seeded MNIST-shaped IDX files;
    the same DBN fit in process (timed, with iterations cut), then
    ``losses.score("blocked_mcxent", y, (h, head))`` on its head through
    kernel #4 (counted from 0 before the fit, read after the loss);
    mlp, LeNet and Hessian-free fits on the card against the CPU."""
    import numpy as np
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.datasets import (DataSet,
                                                   MnistDataFetcher,
                                                   MnistDataSetIterator,
                                                   mnist_idx)
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.conf import OptimizationAlgorithm
    from deeplearning4j_tpu_torch.observability import TRACER
    from deeplearning4j_tpu_torch.ops import losses
    from deeplearning4j_tpu_torch.optimize import solvers

    t_phase = time.perf_counter()
    rep: dict = {"card": card}
    with tempfile.TemporaryDirectory(prefix="dl4j_smoke_") as tmpdir:
        tmp = Path(tmpdir)
        write_mnist(np, mnist_idx, tmp / "mnist")
        env = dict(os.environ, DL4J_TPU_DATA=str(tmp),
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT)] + [p for p in [os.environ.get(
                           "PYTHONPATH")] if p]))
        cli = [sys.executable, "-m", "deeplearning4j_tpu_torch"]
        saved = tmp / "dbn.pkl"
        runs = {}
        for name, args in (
                ("train", ["train", "--model", "dbn", "--dataset", "mnist",
                           "--batch", str(DL4J_ROWS), "--out", str(saved)]),
                ("evaluate", ["evaluate", str(saved), "--dataset", "mnist",
                              "--batch", str(DL4J_ROWS)])):
            t0 = time.perf_counter()
            r = subprocess.run(cli + args, env=env, cwd=tmp,
                               capture_output=True, text=True, timeout=600)
            runs[name] = (r, time.perf_counter() - t0)
            if r.returncode != 0:
                fail(f"dl4j CLI {name} exited {r.returncode}: "
                     f"{r.stderr[-2000:]}")
            if "falling back" in r.stderr or "digits_fallback" in r.stderr:
                fail(f"dl4j CLI {name} did not read the IDX files")
        trained, f1 = cli_stats(runs["train"][0].stdout)
        evaluated, _ = cli_stats(runs["evaluate"][0].stdout)
        if evaluated != trained:
            fail(f"dl4j: evaluate does not reproduce train's stats:\n"
                 f"{trained}\n---\n{evaluated}")
        chance = 1.0 / 10
        if f1 < 3 * chance:
            fail(f"dl4j: the CLI's DBN F1 {f1} is under 3x chance")
        rep.update(cli_f1=f1, chance_f1=chance,
                   cli_train_s=runs["train"][1],
                   cli_evaluate_s=runs["evaluate"][1])
        print(f"dl4j CLI: train {runs['train'][1]:.2f} s, evaluate "
              f"{runs['evaluate'][1]:.2f} s (processes), F1 {f1} (chance "
              f"{chance}), evaluate reproduces train's stats", flush=True)

        # the CLI's data: the first batch, normalized, shuffled
        it = MnistDataSetIterator(batch=DL4J_ROWS, data_dir=tmp / "mnist")
        ds = it.next().normalize_zero_mean_unit_variance().shuffle(seed=42)
        if it.fetcher.source != "idx":
            fail(f"dl4j: the MNIST fetcher's source is {it.fetcher.source}")
        raw = MnistDataFetcher(binarize=False, flatten=False,
                               data_dir=tmp / "mnist")
        raw.fetch(512)
        images = raw.next()

    # ---- the main path: the DBN at the CLI's shape, timed by its spans,
    # then its head's loss through kernel #4
    def dbn(p_it, f_it):
        return zoo.dbn(784, 10, pretrain_iterations=p_it,
                       finetune_iterations=f_it, device="cuda")

    warm = dbn(1, 1)
    warm.init(0)
    warm.fit(ds)                              # the same shapes, untimed
    torch.cuda.synchronize()
    spans, listening = [], [True]
    TRACER.add_listener(lambda ev: listening[0] and spans.append(ev))
    try:
        net = dbn(DL4J_PRETRAIN_IT, DL4J_FINETUNE_IT)
        net.init(0)
        reset_counts(wrappers)
        net.fit(ds)
        torch.cuda.synchronize()
        h = net.feed_forward(ds.features)[2]          # the head's input
        head = net.params[-1]["W"]
        y = torch.as_tensor(ds.labels, device="cuda")
        got = losses.score("blocked_mcxent", y, (h, head))
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in wrappers}
        t0 = time.perf_counter()
        ev = net.evaluate(ds)
        eval_s = time.perf_counter() - t0
    finally:
        listening[0] = False
    expected = {name: 0 for name in counts}
    expected["blocked_cross_entropy"] = 1
    if counts != expected:
        fail(f"dl4j: launches {counts}, the path implies {expected}")
    dur = {}
    for sp in spans:
        key = sp["name"] + ("" if "layer" not in sp["args"] else
                            f"[{sp['args']['layer']}]")
        dur[key] = sp["dur"] / 1e6
    n_pre = sum(1 for k in dur if k.startswith("multilayer.pretrain_layer"))
    fit_s = dur["multilayer.fit"]
    rep.update(
        pretrain_step_ms=[dur[f"multilayer.pretrain_layer[{i}]"] * 1e3
                          / DL4J_PRETRAIN_IT for i in range(n_pre)],
        finetune_iteration_ms=dur["multilayer.finetune"] * 1e3
        / DL4J_FINETUNE_IT,
        fit_s=fit_s,
        examples_per_s=DL4J_ROWS * (n_pre * DL4J_PRETRAIN_IT
                                    + DL4J_FINETUNE_IT) / fit_s,
        evaluate_s=eval_s, in_process_f1=ev.f1(),
        iterations={"pretrain": DL4J_PRETRAIN_IT,
                    "finetune": DL4J_FINETUNE_IT},
        launches=counts)

    # ---- kernel #4 from the DL4J side against its plain version
    N, D, V = h.shape[0], h.shape[1], head.shape[1]
    tg = y.argmax(-1).to(torch.int32)
    w = torch.ones((N,), device="cuda")
    rw, rl = txe.reference_xent_rows(h, head, tg, w)
    mean_err = abs(got.item() - (rw.sum() / N).item())
    wl, lse = txe.xent_fwd(h, head, tg, w)                # uncounted
    err = max((wl - rw).abs().max().item(), (lse - rl).abs().max().item())
    if not (err < TOL_DL4J_XENT and mean_err < TOL_DL4J_XENT
            and torch_isfinite(wl)):
        fail(f"dl4j blocked_mcxent: max err {err}, mean err {mean_err} "
             f"(tol {TOL_DL4J_XENT})")
    nbytes = N * D * 4 + D * V * 4 + N * 4 * 4
    n_copy = copies_for(nbytes)
    hs = [h.clone() for _ in range(n_copy)]
    heads = [head.clone() for _ in range(n_copy)]
    ms = device_ms(torch, [lambda a=a, b=b: txe.xent_fwd(a, b, tg, w)
                           for a, b in zip(hs, heads)])
    pms = event_ms(torch, lambda: txe.reference_xent_rows(h, head, tg, w), 5)
    tl = tg.long()
    lms = event_ms(torch, lambda: F.cross_entropy(h @ head, tl,
                                                  reduction="sum"), 5)
    del hs, heads
    ops = 2 * N * V * D
    f32_peak = next(r for frag, r in F32_RATES.items() if frag in card)
    t_bytes, t_ops = nbytes / rates[0], ops / f32_peak
    bound = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    cases.append({"kernel": "blocked_cross_entropy", "N": N, "V": V, "D": D,
                  "dtype": "float32", "call": "losses.blocked_mcxent",
                  "max_abs_err": err, "tol": TOL_DL4J_XENT,
                  "mean_loss_err": mean_err, "ms": ms, "plain_ms": pms,
                  "library_ms": lms, "bound_ms": bound, "bound_by": by,
                  "bytes": nbytes, "ops": ops})
    print(f"kernel blocked_cross_entropy (losses.blocked_mcxent) N={N} V={V} "
          f"D={D} f32: max_err={err:.3g} mean_err={mean_err:.3g} "
          f"kernel_ms={ms:.5f} plain_ms={pms:.5f} library_ms={lms:.5f} "
          f"bound_ms={bound:.5f} ({by})", flush=True)

    # ---- card against CPU on the deterministic paths
    def mlp(dev):
        return zoo.mlp(784, 10, num_iterations=50, device=dev)

    def lenet(dev):
        return zoo.lenet(10, num_iterations=10, device=dev)

    def hf(dev):
        base = zoo.mlp(784, 10, hidden=(64,), num_iterations=3, device=dev)
        confs = list(base.conf.confs)
        confs[-1] = confs[-1].replace(
            optimization_algo=OptimizationAlgorithm.HESSIAN_FREE)
        return type(base)(base.conf.replace(confs=tuple(confs)), device=dev)

    cg_solves = []

    @contextlib.contextmanager
    def no_sync_cg():
        """The card's CG solves under set_sync_debug_mode("error")."""
        orig = solvers.StochasticHessianFree._cg_solve

        def guarded(self, *a, **kw):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = orig(self, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            cg_solves.append(1)
            return out

        solvers.StochasticHessianFree._cg_solve = guarded
        try:
            yield
        finally:
            solvers.StochasticHessianFree._cg_solve = orig

    rep["card_vs_cpu"] = {
        "mlp_784_256_10_50it": first_order_card_vs_cpu(
            torch, mlp, DataSet(ds.features[:2048], ds.labels[:2048]),
            "mlp"),
        "lenet_10it": first_order_card_vs_cpu(torch, lenet, images,
                                              "lenet"),
        "hessian_free_784_64_10_3it": card_vs_cpu(
            torch, hf, DataSet(ds.features[:1024], ds.labels[:1024]),
            "hessian_free", hooks=no_sync_cg)}
    if len(cg_solves) != 3:
        fail(f"dl4j: {len(cg_solves)} CG solves ran under the sync check")
    rep["phase_s"] = time.perf_counter() - t_phase
    print("dl4j: " + json.dumps(rep), flush=True)
    # the head's vocabulary: its xent rows are not the LM's at N rows
    leg = {"batch": N, "seq": 1, "causal": None, "vocab": V,
           "launches": counts}
    return rep, leg


# ------------------------------------------------------------------ ResNet, LSTM, text

RESNET_BATCH = 256
RESNET_IMAGE = 224
RESNET_STEPS = 10
# ResNet-18 (width 8, f32, 32x32, batch 32) on the card against the CPU:
# the logits, and the parameters and running stats after one
# ``ResNet.train_step``, each within this share of the leaf's largest
# |value| (at least 1); the loss within it absolutely
TOL_RESNET_CARD = 1e-4
# ResNet-50's loss in bf16 against the f32 model on the same weights and
# batch, relative
TOL_RESNET_BF16 = 0.02
# the LSTM's losses over the CPU-comparison epochs, card against CPU
TOL_LSTM = 1e-4
# a small Word2Vec HS fit, card against CPU, every table entry
TOL_W2V_CARD = 1e-4
#: 30 repeats (60 before phase 15j): the beam reads "defg" after as many
#: epochs at either length (90 on the CPU), each epoch half the steps
LSTM_TEXT = "abcdefg " * 30
#: the card's fit (110 epochs: the CPU's beam first reads "defg" at 100;
#: 150 before phase 15h, ~18 s more)
LSTM_EPOCHS = 110
LSTM_CMP_EPOCHS = 20
# word2vec's subsampling of frequent words: with none (the reference's
# default, 0) both packages' batched updates diverge to NaN on a Zipfian
# topic corpus (the most frequent word is the center of a few hundred
# pairs a batch, their updates summed; tests/test_torch_text.py pins it);
# 1e-3 is the original word2vec's setting
WORD2VEC_SAMPLE = 1e-3
TEXT_TOKENS = 800_000          # 1M before phase 15j
TEXT_VOCAB = 10_000
TEXT_TOPICS = 20


def resnet_kernel_class(name: str) -> str:
    """The layer a device kernel of the ResNet step belongs to."""
    low = name.lower()
    if any(s in low for s in ("nchwtonhwc", "nhwctonchw", "transpose")):
        return "layout transposes"
    if any(s in low for s in ("conv", "xmma", "cudnn", "implicit",
                              "fprop", "dgrad", "wgrad", "cutlass")):
        return "convolutions (cuDNN)"
    if "gemm" in low or low.startswith("nvjet"):
        return "GEMM (head)"
    if any(s in low for s in ("reduce", "welford", "var_mean", "norm")):
        return "BN statistics (reductions)"
    return "BN normalize, ReLU, pool, casts, optimizer (elementwise)"


def _launch_free(wrappers, label):
    """The kernels' counts after a phase that launches none of them."""
    counts = {w.__name__: w.launches for w in wrappers}
    if any(counts.values()):
        fail(f"{label}: a port kernel was launched on a path without one: "
             f"{counts}")
    return counts


def _rel_err(torch, got, want) -> float:
    """max |got - want| over max(max |want|, 1), over matching leaves."""
    from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves

    err = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        err = max(err, ((a - b).abs().max()
                        / max(b.abs().max().item(), 1.0)).item())
    return err


def run_resnet(torch, TT, wrappers, rates, card, dev="cuda",
               batch=RESNET_BATCH, size=RESNET_IMAGE, steps=RESNET_STEPS,
               classes=1000):
    """ResNet-50 (bf16, s2d stem, ``bn_fold=False``) trained as the JAX
    package's benchmark leg trains it: ``value_and_grad(cross_entropy)``
    and ``chain(momentum(0.9), sgd_lr(1e-2))`` at ``batch`` images of
    ``size``^2 from a seeded numpy generator with one-hot labels; one
    warm-up step, ``steps`` timed on CUDA events (p50 step, images/s,
    MFU, peak memory) on one fixed batch, whose loss must stay finite
    and fall; one profiled step (device time by class).  Then ResNet-18
    (width 8, f32, 32^2) forward and one ``train_step`` on the card
    against the CPU, and ResNet-50's bf16 loss against its f32 loss on
    the card over the same weights and 32 images."""
    import dataclasses
    import math

    import numpy as np

    from deeplearning4j_tpu_torch.models import resnet as trn
    from deeplearning4j_tpu_torch.optimize.transforms import apply_updates
    from deeplearning4j_tpu_torch.utils.autodiff import value_and_grad

    t_phase = time.perf_counter()
    cfg = trn.ResNetConfig.resnet50(num_classes=classes)
    params = trn.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
    tx = TT.chain(TT.momentum(0.9), TT.sgd_lr(1e-2))
    grad = value_and_grad(trn.cross_entropy)

    def step(params, opt, images, labels):
        count, st = opt
        loss, g = grad(params, images, labels, cfg)
        updates, st = tx.update(g, st, params, count)
        return apply_updates(params, updates), (count + 1, st), loss

    rng = np.random.default_rng(1)
    images = torch.as_tensor(rng.standard_normal(
        (batch, size, size, 3), dtype=np.float32), device=dev)
    labels = torch.as_tensor(np.eye(classes, dtype=np.float32)[
        rng.integers(0, classes, batch)], device=dev)
    opt = (0, tx.init(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    params, opt, loss = step(params, opt, images, labels)     # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    marks[0].record()
    for i in range(steps):
        params, opt, loss = step(params, opt, images, labels)
        marks[i + 1].record()
        losses.append(loss)
    torch.cuda.synchronize()
    counts = _launch_free(wrappers, "resnet")
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    losses = [x.item() for x in losses]
    if not all(math.isfinite(x) for x in losses):
        fail(f"resnet: non-finite loss in {losses}")
    if not losses[-1] < losses[1]:
        fail(f"resnet: the loss did not fall over {steps} steps on a fixed "
             f"batch: {losses}")
    p50 = sorted(times)[len(times) // 2]
    fpi = cfg.flops_per_image(size)
    rep = {"card": card, "config": str(cfg), "batch": batch, "image": size,
           "steps": steps, "warmup_s": warm_s, "step_s": times,
           "p50_step_s": p50, "images_per_s": batch / p50,
           "flops_per_image": fpi, "mfu": fpi * batch / p50 / rates[1],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": losses, "launches": counts}
    rep["profile"] = profile_step(torch, step, params, opt, (images, labels),
                                  classify=resnet_kernel_class)
    print(f"resnet50: {card} | batch {batch}x{size}^2 bf16 p50_step_ms="
          f"{p50 * 1e3:.2f} images_per_s={rep['images_per_s']:.1f} mfu="
          f"{rep['mfu']:.4f} peak_mem_gb={rep['peak_mem_gb']:.2f} losses="
          f"{[round(x, 4) for x in losses]}", flush=True)
    del params, opt, images, labels
    torch.cuda.empty_cache()

    # ---- ResNet-50 in bf16 against f32 on the same weights and batch
    p50w = trn.init_params(torch.Generator(device=dev).manual_seed(2), cfg,
                           dev)
    x = torch.as_tensor(rng.standard_normal((32, size, size, 3),
                                            dtype=np.float32), device=dev)
    y = torch.as_tensor(np.eye(classes, dtype=np.float32)[
        rng.integers(0, classes, 32)], device=dev)
    with torch.no_grad():
        l16 = trn.cross_entropy(p50w, x, y, cfg).item()
        l32 = trn.cross_entropy(p50w, x, y, dataclasses.replace(
            cfg, dtype=torch.float32)).item()
    rep["bf16_vs_f32"] = {"loss_bf16": l16, "loss_f32": l32,
                          "rel_err": abs(l16 - l32) / abs(l32),
                          "tol": TOL_RESNET_BF16}
    if not rep["bf16_vs_f32"]["rel_err"] < TOL_RESNET_BF16:
        fail(f"resnet50: bf16 loss {l16} vs f32 {l32} (tol "
             f"{TOL_RESNET_BF16})")
    del p50w, x, y
    torch.cuda.empty_cache()

    # ---- ResNet-18 on the card against the CPU
    small = trn.ResNetConfig.resnet18(num_classes=5, width=8,
                                      dtype=torch.float32)
    xs = rng.standard_normal((32, 32, 32, 3), dtype=np.float32)
    ys = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 32)]
    out = {}
    for d in ("cpu", dev):
        model = trn.ResNet(small, device=d)
        model.init()                           # a CPU generator, seed 0
        logits = model.predict_logits(torch.as_tensor(xs))
        stx = TT.chain(TT.momentum(0.9), TT.sgd_lr(1e-2))
        p, st, _, loss = model.train_step(stx)(
            model.params, model.batch_stats, (0, stx.init(model.params)),
            torch.as_tensor(xs, device=d), torch.as_tensor(ys, device=d))
        out[d] = (logits, p, st, loss.item())
    errs = {"logits": _rel_err(torch, out[dev][0], out["cpu"][0]),
            "params": _rel_err(torch, out[dev][1], out["cpu"][1]),
            "running_stats": _rel_err(torch, out[dev][2], out["cpu"][2]),
            "loss": abs(out[dev][3] - out["cpu"][3])}
    rep["card_vs_cpu_resnet18"] = dict(errs, tol=TOL_RESNET_CARD)
    if not all(e < TOL_RESNET_CARD for e in errs.values()):
        fail(f"resnet18: card vs CPU {errs} (tol {TOL_RESNET_CARD})")
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"resnet: {card} | bf16_vs_f32={rep['bf16_vs_f32']} "
          f"card_vs_cpu_resnet18={rep['card_vs_cpu_resnet18']} "
          f"phase_s={rep['phase_s']:.1f} launches={counts}", flush=True)
    return rep


def run_lstm(torch, wrappers, card, dev="cuda", epochs=LSTM_EPOCHS,
             cmp_epochs=LSTM_CMP_EPOCHS):
    """``examples/05_lstm_textgen.py``'s flow on the card: an
    ``LSTMSequenceModel`` (hidden 48) fit on a repetitive character
    stream, ``predict_next``, ``beam_search`` (which must continue
    "abc" with "defg") and ``sample``.  The card and the CPU fit
    ``cmp_epochs`` epochs from the same parameters (losses within
    ``TOL_LSTM``; their ``predict_next``, beams and samples equal); the
    card then fits on to ``epochs`` (timed) and samples 200 tokens
    (tokens/s)."""
    from deeplearning4j_tpu_torch.models.lstm import LSTMSequenceModel

    t_phase = time.perf_counter()
    import numpy as np

    chars = sorted(set(LSTM_TEXT))
    idx = {c: i for i, c in enumerate(chars)}
    tokens = np.array([idx[c] for c in LSTM_TEXT], dtype=np.int32)
    prime = [idx[c] for c in "abc"]
    models = {}
    for d in ("cpu", dev):
        m = LSTMSequenceModel(vocab_size=len(chars), hidden_size=48, seed=0,
                              device=d)
        m.init()                               # a CPU generator, seed 0
        models[d] = m
    reset_counts(wrappers)
    losses = {d: m.fit_sequence(tokens, epochs=cmp_epochs)
              for d, m in models.items()}
    err = max(abs(a - b) for a, b in zip(losses[dev], losses["cpu"]))
    decoded = {d: (m.predict_next(prime), m.beam_search(prime, 12, 4)[0],
                   m.sample(prime, 12, temperature=0.5, seed=1))
               for d, m in models.items()}
    if not err < TOL_LSTM:
        fail(f"lstm: card vs CPU losses differ by {err} (tol {TOL_LSTM})")
    if decoded[dev] != decoded["cpu"]:
        fail(f"lstm: card decodes {decoded[dev]}, CPU {decoded['cpu']}")
    card_m = models[dev]
    t0 = time.perf_counter()
    more = card_m.fit_sequence(tokens, epochs=epochs - cmp_epochs)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    beam, score = card_m.beam_search(prime, 12, 4)
    text = "".join(chars[i] for i in beam[len(prime):])
    if not text.startswith("defg"):
        fail(f"lstm: beam search after 'abc' gives {text!r}")
    t0 = time.perf_counter()
    sampled = card_m.sample(prime, 200, temperature=0.5, seed=0)
    sample_s = time.perf_counter() - t0
    counts = _launch_free(wrappers, "lstm")
    steps = len(tokens) - 1
    rep = {"card": card, "hidden": 48, "vocab": len(chars),
           "seq_steps": steps, "epochs": epochs,
           "cmp_epochs": cmp_epochs, "card_vs_cpu_loss_err": err,
           "tol": TOL_LSTM, "decoded_equal": True,
           "loss_first_last": [losses[dev][0], more[-1]],
           "fit_s": fit_s, "epoch_ms": fit_s * 1e3 / (epochs - cmp_epochs),
           "train_steps_per_s": steps * (epochs - cmp_epochs) / fit_s,
           "beam": text, "beam_logp": score,
           "sample_tokens_per_s": 200 / sample_s,
           "sampled": "".join(chars[i] for i in sampled[len(prime):][:24]),
           "launches": counts,
           "phase_s": time.perf_counter() - t_phase}
    print(f"lstm: {card} | " + json.dumps(rep), flush=True)
    return rep


def topic_corpus(np, n_tokens=TEXT_TOKENS, vocab=TEXT_VOCAB,
                 topics=TEXT_TOPICS, seed=0, sent_len=20):
    """A seeded synthetic corpus: sentences of ``sent_len`` words, each
    sentence about one topic.  A fifth of the vocabulary is shared
    (function words, Zipf-distributed over the whole corpus); the rest
    splits evenly among the topics, each topic's words Zipf-distributed
    within it; 60% of a sentence's words are its topic's.  Returns the
    sentences, their topics and each topic's word lists."""
    rng = np.random.default_rng(seed)
    n_shared = vocab // 5
    per_topic = (vocab - n_shared) // topics

    def zipf(n):
        p = 1.0 / np.arange(1, n + 1)
        return p / p.sum()

    n_sent = n_tokens // sent_len
    topic_of = rng.integers(0, topics, n_sent)
    own = rng.random((n_sent, sent_len)) < 0.6
    shared_w = rng.choice(n_shared, (n_sent, sent_len), p=zipf(n_shared))
    topic_w = (n_shared + topic_of[:, None] * per_topic
               + rng.choice(per_topic, (n_sent, sent_len), p=zipf(per_topic)))
    words = np.where(own, topic_w, shared_w)
    names = np.array([f"w{i}" for i in range(vocab)])
    sentences = [" ".join(row) for row in names[words]]
    topic_words = [[f"w{n_shared + t * per_topic + i}" for i in range(10)]
                   for t in range(topics)]
    return sentences, topic_of, topic_words


def topic_similarity(model, topic_words) -> tuple[float, float]:
    """Mean cosine similarity of word pairs within a topic and across
    topics (each topic against the next), over each topic's ten most
    frequent words; one host copy of the table."""
    import numpy as np

    table = model.syn0.detach().cpu().numpy()
    idx = [[model.vocab.index_of(w) for w in ws] for ws in topic_words]
    if min(min(ix) for ix in idx) < 0:
        fail("text: a topic word is missing from the vocabulary")
    unit = table / np.maximum(np.linalg.norm(table, axis=1, keepdims=True),
                              1e-12)
    within, across = [], []
    for t, ix in enumerate(idx):
        sims = unit[ix] @ unit[ix].T
        within.extend(sims[np.triu_indices(len(ix), 1)])
        across.extend((unit[ix] @ unit[idx[(t + 1) % len(idx)]].T).ravel())
    return float(np.mean(within)), float(np.mean(across))


def _timed_fit(torch, model, build_first=True):
    """(fit wall s, vocab s, the TRACER spans of the fit by name)."""
    from deeplearning4j_tpu_torch.observability import TRACER

    spans = []
    listening = [True]
    TRACER.add_listener(lambda ev: listening[0] and spans.append(ev))
    try:
        t0 = time.perf_counter()
        if build_first:
            model.build_vocab()
        vocab_s = time.perf_counter() - t0
        model.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        listening[0] = False
    by = {}
    for sp in spans:
        by.setdefault(sp["name"], []).append(sp)
    return wall, vocab_s, by


def run_text(torch, wrappers, card, dev="cuda"):
    """The text pipeline on the card.  The native host library must load
    (a missing one fails here rather than passing on the Python
    parsers).  A seeded topic corpus of ~800k tokens over a ~10k-word
    Zipfian vocabulary (``topic_corpus``); Word2Vec at the reference's
    defaults (layer 100, window 5, batch 4096) but for subsampling
    (``WORD2VEC_SAMPLE``) with hierarchical softmax, then with 5
    negatives; GloVe and ParagraphVectors on slices of it;
    pairs/s, entries/s and the host's share of each fit; within-topic
    similarity above cross-topic for each model; a small HS fit on the
    card against the CPU within ``TOL_W2V_CARD``; then
    ``examples/08_svmlight_records.py``'s flow: a seeded svmlight file
    parsed natively (equal to the Python parser), split by byte ranges,
    and ``zoo.mlp`` fit from it on the card against the CPU.  Returns the
    report, the negative-sampling Word2Vec model and the topics' words."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import svmlight
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.native import runtime as native_rt
    from deeplearning4j_tpu_torch.text import Glove, ParagraphVectors, Word2Vec

    t_phase = time.perf_counter()
    if native_rt.lib() is None:
        fail("text: the native host library did not build or load "
             "(g++ is needed beside nvcc)")
    t0 = time.perf_counter()
    sents, topic_of, topic_words = topic_corpus(np)
    corpus_s = time.perf_counter() - t0
    n_tok = sum(s.count(" ") + 1 for s in sents)
    rep: dict = {"card": card, "corpus": {
        "tokens": n_tok, "sentences": len(sents), "vocab": TEXT_VOCAB,
        "topics": TEXT_TOPICS, "build_s": corpus_s}}
    reset_counts(wrappers)

    # ---- Word2Vec: hierarchical softmax, then negative sampling
    for label, kw in (("word2vec_hs", {}),
                      ("word2vec_ns", dict(negative=5,
                                           use_hierarchic_softmax=False))):
        model = Word2Vec(sents, seed=1, sample=WORD2VEC_SAMPLE, device=dev,
                         **kw)
        wall, vocab_s, spans = _timed_fit(torch, model)
        pairs_s = sum(sp["dur"] for sp in spans["word2vec.pairs"]) / 1e6
        n_pairs = sum(sp["args"]["pairs"] for sp in spans["word2vec.epoch"])
        steps_s = wall - vocab_s - pairs_s
        if not bool(torch.isfinite(model.syn0).all()):
            fail(f"text {label}: non-finite embeddings")
        within, across = topic_similarity(model, topic_words)
        if not within > across:
            fail(f"text {label}: within-topic similarity {within} is not "
                 f"above cross-topic {across}")
        rep[label] = {"vocab": len(model.vocab), "pairs": n_pairs,
                      "fit_s": wall, "vocab_s": vocab_s,
                      "pairs_host_s": pairs_s, "device_steps_s": steps_s,
                      "pairs_per_s": n_pairs / steps_s,
                      "host_share": (vocab_s + pairs_s) / wall,
                      "within_topic_sim": within, "cross_topic_sim": across}
        print(f"text {label}: {card} | " + json.dumps(rep[label]),
              flush=True)
    w2v_ns = model          # the negative-sampling model: run_embed_plot's
    del model
    # ---- GloVe on a fifth of the corpus
    part = sents[:len(sents) // 5]
    glove = Glove(part, seed=1, device=dev)
    wall, _, spans = _timed_fit(torch, glove, build_first=False)
    co_s = sum(sp["dur"] for sp in spans["glove.cooccurrence"]) / 1e6
    entries = spans["glove.epoch"][0]["args"]["entries"]
    n_it = len(spans["glove.epoch"])
    within, across = topic_similarity(glove, topic_words)
    if not (within > across and glove.losses[-1] < glove.losses[0]):
        fail(f"text glove: similarity {within} vs {across}, losses "
             f"{glove.losses}")
    rep["glove"] = {"tokens": n_tok // 5, "entries": entries,
                    "iterations": n_it, "fit_s": wall,
                    "cooccurrence_host_s": co_s,
                    "device_steps_s": wall - co_s,
                    "entries_per_s": entries * n_it / (wall - co_s),
                    "host_share": co_s / wall, "losses": glove.losses,
                    "within_topic_sim": within, "cross_topic_sim": across}
    print(f"text glove: {card} | " + json.dumps(rep["glove"]), flush=True)
    del glove
    # ---- ParagraphVectors (HS) on 4000 sentences
    docs = sents[:4000]
    labels = [f"DOC_{i}" for i in range(len(docs))]
    pv = ParagraphVectors(docs, labels, seed=1, device=dev)
    t0 = time.perf_counter()
    pv.fit()
    torch.cuda.synchronize()
    pv_s = time.perf_counter() - t0
    if not bool(torch.isfinite(pv.doc_vectors).all()):
        fail("text paragraph_vectors: non-finite doc vectors")
    same = [i for i in range(1, 200) if topic_of[i] == topic_of[0]]
    diff = [i for i in range(1, 200) if topic_of[i] != topic_of[0]]
    sim_same = float(np.mean([pv.doc_similarity("DOC_0", f"DOC_{i}")
                              for i in same]))
    sim_diff = float(np.mean([pv.doc_similarity("DOC_0", f"DOC_{i}")
                              for i in diff]))
    if not sim_same > sim_diff:
        fail(f"text paragraph_vectors: same-topic doc similarity {sim_same}"
             f" is not above other-topic {sim_diff}")
    rep["paragraph_vectors"] = {"docs": len(docs), "fit_s": pv_s,
                                "same_topic_sim": sim_same,
                                "other_topic_sim": sim_diff}
    del pv
    # ---- a small HS fit: card against CPU
    small = {}
    for d in ("cpu", dev):
        m = Word2Vec(sents[:2000], layer_size=32, window=3, seed=3,
                     device=d).fit()
        small[d] = (m.syn0.cpu(), m.syn1.cpu())
    w2v_err = max((small[dev][i] - small["cpu"][i]).abs().max().item()
                  for i in (0, 1))
    rep["word2vec_card_vs_cpu"] = {"max_abs_err": w2v_err,
                                   "tol": TOL_W2V_CARD}
    if not w2v_err < TOL_W2V_CARD:
        fail(f"text: a small HS fit differs card vs CPU by {w2v_err}")
    # ---- examples/08: svmlight records -> zoo.mlp on the card
    rng = np.random.default_rng(0)
    n, d = 400, 12
    ylab = rng.integers(0, 2, n)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    feats = np.where(rng.random((n, d)) < 0.5, 0.0, feats)
    feats += 2.0 * ylab[:, None] * np.eye(d, dtype=np.float32)[0]
    with tempfile.TemporaryDirectory(prefix="svmlight_smoke_") as tmp:
        path = Path(tmp) / "corpus.svmlight"
        svmlight.save_svmlight(path, feats, ylab)
        size = path.stat().st_size
        raw = path.read_bytes()
        t0 = time.perf_counter()
        parsed = native_rt.parse_svmlight(raw, d)
        native_s = time.perf_counter() - t0
        if parsed is None:
            fail("text: the native svmlight parser refused a valid file")
        py = np.stack([svmlight.parse_svmlight_line(l, d)[0]
                       for l in raw.decode().splitlines()])
        if not np.array_equal(parsed[0], py):
            fail("text: native svmlight parse differs from Python's")
        cuts = [0, size // 2, size]
        split_rows = [svmlight.load_svmlight(path, d, 2, start=s, end=e)[0]
                      .shape[0] for s, e in zip(cuts, cuts[1:])]
        if sum(split_rows) != n:
            fail(f"text: byte-range splits hold {split_rows} records")
        def mlp(dv, iterations=60):
            return zoo.mlp(d, 2, hidden=(16,), num_iterations=iterations,
                           device=dv)

        it = svmlight.SVMLightDataSetIterator(path, batch=100,
                                              num_features=d, num_classes=2)
        # 10 iterations on the first batch on the card and the CPU from
        # the same parameters; then the example's loop (4 batches x 60
        # iterations) on the card alone: once the loss is near 0, AdaGrad
        # scales near-zero gradients by lr / sqrt(1e-6) and the two
        # sides' f32 rounding drifts past TOL_DL4J over the whole loop
        vs_cpu = card_vs_cpu(torch, lambda dv: mlp(dv, 10), it.next(),
                             "svmlight mlp")
        it.reset()
        net = mlp(dev)
        net.init(0)
        t0 = time.perf_counter()
        while it.has_next():
            net.fit(it.next())
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        f_all, l_all = svmlight.load_svmlight(path, d, 2)
    acc = float((net.predict(f_all) == l_all.argmax(-1)).mean())
    rep["svmlight"] = {"records": n, "bytes": size,
                       "native_parse_ms": native_s * 1e3,
                       "split_records": split_rows,
                       "card_vs_cpu_first_batch": vs_cpu, "fit_s": fit_s,
                       "accuracy": acc}
    rep["launches"] = _launch_free(wrappers, "text")
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"text: {card} | paragraph_vectors={rep['paragraph_vectors']} "
          f"word2vec_card_vs_cpu={rep['word2vec_card_vs_cpu']} svmlight="
          f"{rep['svmlight']} phase_s={rep['phase_s']:.1f}", flush=True)
    return rep, w2v_ns, topic_words


#: 15e, the RNTN pipeline: seeded sentences of 8-24 tokens (the final
#: "." included) built on the tag sequences of the tagger's sample corpus
#: (``text/data/pos_sample.txt``), each slot filled from that corpus's
#: words of the tag, or in ``TREE_SENTIMENT_RATE`` of the adjective, verb
#: and adverb slots from SentiWordNet's seed words
#: (2,000 before phase 15h: ~17 s more of parse and fit)
TREE_SENTENCES = 1200
#: processes parsing them (the host's CKY: 21-26 s in one on an H100's
#: host, ~40% of the phase)
TREE_PARSE_WORKERS = 8
TREE_LENGTHS = (8, 24)
TREE_SENTIMENT_RATE = 0.35
TREE_SENTIMENT_WORDS = {
    "ADJ": ("good", "great", "excellent", "happy", "wonderful", "best",
            "nice", "amazing", "bad", "terrible", "awful", "sad",
            "horrible", "worst", "poor", "disappointing", "boring"),
    "VERB": ("love", "hate", "like"), "ADV": ("not", "never")}
#: SentiWordNet's judgments as the Stanford Sentiment Treebank's classes
SST_CLASSES = {"strong_negative": 0, "negative": 1, "neutral": 2,
               "positive": 3, "strong_positive": 4}
#: the RNTN's epochs on the card (10 before phase 15h, ~28 s more: the
#: loss falls most in the first 4, 0.91 -> 0.57 of 0.52 at 10 in the last
#: whole run with 10)
RNTN_EPOCHS = 4
RNTN_BATCH = 32
#: AdaGrad steps held card against CPU in float64, each from the CPU's
#: state before it.  Free-running, the RNTN's AdaGrad start is chaotic:
#: g / sqrt(h + 1e-8) has slope lr / 1e-4 = 500 at a small gradient, and
#: on the CPU a 1e-12 relative nudge of the parameters grows to 1.3e-4
#: after 7 steps and to 0.46 after 10 (float64, this phase's corpus), so
#: the card's float64 run leaves the CPU's after ~10 steps by summation
#: order alone (0.84 after 20 on an H100)
RNTN_CMP_STEPS = 20
TAG_SENTENCES = 200
#: 15f: k-means over every Word2Vec vector, exact t-SNE over the most
#: frequent words
KMEANS_K = 20
TSNE_WORDS = 5000
TSNE_CMP_ITERS = 10          # 20 before phase 15j
# k-means, card against CPU from one seed: the inertia, relative; the
# labels equal but where a point's two nearest centroids lie within this
# of each other, relative
TOL_KMEANS = 1e-5
# exact t-SNE, card against CPU: P (max |diff| / max P), and
# TSNE_CMP_ITERS iterations from one y (max |diff| / max |y|) in float64.
# P follows the float32 distances |x|^2 - 2 x.y + |y|^2 (the reference's
# formula), whose cancellation leaves ~1e-7 of |x|^2 in a near distance:
# the card's P read 1.35e-5 from the CPU's on an H100 (the JAX package's
# and the port's 7.2e-5 apart on the CPU, on the reference tests' blobs),
# so P is held at 1e-4.
# Float32 iterations are reported, not held: the exaggerated start (P x
# 4, learning rate 200) amplifies rounding, and from the same P and y the
# JAX package and the port, which differ in summation order alone, part
# by 1.8e-4 of the scale after 20 iterations at 5000 x 100 (by ~0.7 on
# the reference tests' 60 points) on the CPU
TOL_TSNE_P = 1e-4
TOL_TSNE_Y = 1e-4


def tree_corpus(np, n=TREE_SENTENCES, seed=0):
    """``n`` seeded sentences (see ``TREE_LENGTHS``): tag templates from
    the sample corpus joined by CONJ until the length is reached, each
    slot filled with a word of its tag."""
    from deeplearning4j_tpu_torch.text.annotator import (_DATA,
                                                         load_tagged_corpus)

    tagged = load_tagged_corpus(_DATA / "pos_sample.txt")
    by_tag: dict = {}
    for sent in tagged:
        for w, t in sent:
            by_tag.setdefault(t, set()).add(w.lower())
    by_tag = {t: sorted(ws) for t, ws in by_tag.items()}
    templates = [[t for _, t in s if t != "."] for s in tagged]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(TREE_LENGTHS[0], TREE_LENGTHS[1] + 1)) - 1
        tags: list = []
        while len(tags) < length:
            if tags:
                tags.append("CONJ")
            tags.extend(templates[rng.integers(len(templates))])
        words = []
        for t in tags[:length]:
            pool = by_tag[t]
            if t in TREE_SENTIMENT_WORDS and rng.random() < TREE_SENTIMENT_RATE:
                pool = TREE_SENTIMENT_WORDS[t]
            words.append(pool[rng.integers(len(pool))])
        out.append(" ".join(words) + " .")
    return out


def _parse_sentences(sents):
    """Worker of ``run_trees``' parse: a default ``TreebankParser`` of its
    own; the binarized trees of ``sents`` in order, and its seconds."""
    from deeplearning4j_tpu_torch.text.tree import binarize
    from deeplearning4j_tpu_torch.text.treeparser import TreebankParser

    t0 = time.perf_counter()
    parser = TreebankParser()
    trees = [binarize(parser.get_trees(s)[0]) for s in sents]
    return trees, time.perf_counter() - t0


def parse_trees(sents, workers=TREE_PARSE_WORKERS):
    """``sents`` parsed in ``workers`` spawned processes (the host CKY is
    pure Python), contiguous shares in order: (trees, wall s, the
    workers' summed s)."""
    import concurrent.futures
    import multiprocessing

    workers = max(1, min(workers, os.cpu_count() or 1))
    share = -(-len(sents) // workers)
    parts = [sents[i:i + share] for i in range(0, len(sents), share)]
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            len(parts), mp_context=multiprocessing.get_context("spawn")) as ex:
        done = list(ex.map(_parse_sentences, parts))
    wall = time.perf_counter() - t0
    return [t for trees, _ in done for t in trees], wall, sum(
        s for _, s in done)


def _leaf_err(got: dict, want: dict) -> float:
    """max over the leaves of max |got - want| / max |want| (on the host)."""
    err = 0.0
    for k, w in want.items():
        g = got[k].detach().double().cpu()
        w = w.detach().double().cpu()
        err = max(err, ((g - w).abs().max()
                        / max(w.abs().max().item(), 1e-30)).item())
    return err


def rntn_card_vs_cpu(torch, trntn, model, trees, init, steps=RNTN_CMP_STEPS):
    """The RNTN on the card against the CPU from the same parameters
    (``init``, numpy): the float32 loss and every gradient of the first
    batch, then ``steps`` AdaGrad steps in float64 over consecutive
    batches, each step taken by the card from the CPU's state before it
    (params and AdaGrad sums) and held to the CPU's state after it, each
    within ``TOL_DL4J``.  The free-running float64 trajectories are
    reported, not held: see ``RNTN_CMP_STEPS``."""
    from deeplearning4j_tpu_torch.models.convert import params_from_numpy

    cpu = trntn.RNTN(layer_size=model.d, n_classes=model.n_classes,
                     max_nodes=model.max_nodes, device="cpu")
    cpu.vocab = model.vocab
    batches = [trees[i * RNTN_BATCH:(i + 1) * RNTN_BATCH]
               for i in range(steps)]
    first = {}
    for name, m in (("card", model), ("cpu", cpu)):
        p = params_from_numpy(init, device=m.device)
        first[name] = trntn._loss_and_grads(p, m._batch_arrays(batches[0]),
                                            m.l2)
    loss_err = abs(first["card"][0].item() - first["cpu"][0].item()) \
        / abs(first["cpu"][0].item())
    grad_err = _leaf_err(first["card"][1], first["cpu"][1])

    def to(tree, device):
        return {k: v.to(device) for k, v in tree.items()}

    p = {k: v.double() for k, v in params_from_numpy(
        init, device="cpu").items()}
    h = {k: torch.zeros_like(v) for k, v in p.items()}
    card_p, card_h = to(p, model.device), to(h, model.device)
    cpu_step, card_step = cpu._build_step(), model._build_step()
    step_err = free_err = 0.0
    for b in batches:
        got_p, got_h, _ = card_step(to(p, model.device), to(h, model.device),
                                    model._batch_arrays(b))
        card_p, card_h, _ = card_step(card_p, card_h, model._batch_arrays(b))
        p, h, _ = cpu_step(p, h, cpu._batch_arrays(b))
        step_err = max(step_err, _leaf_err(got_p, p), _leaf_err(got_h, h))
        free_err = _leaf_err(card_p, p)
    rep = {"loss_rel_err": loss_err, "grads_rel_err": grad_err,
           f"adagrad_f64_{steps}_steps_teacher_forced_rel_err": step_err,
           f"adagrad_f64_{steps}_steps_free_running_rel_err": free_err,
           "tol": TOL_DL4J}
    if not (loss_err < TOL_DL4J and grad_err < TOL_DL4J
            and step_err < TOL_DL4J):
        fail(f"trees: the RNTN differs card vs CPU: {rep}")
    return rep


def run_trees(torch, wrappers, card, dev="cuda", n_sent=TREE_SENTENCES,
              epochs=RNTN_EPOCHS, cmp_steps=RNTN_CMP_STEPS):
    """Raw text to a trained RNTN on the card: ``tree_corpus``'s
    sentences joined into one text, split by ``SentenceAnnotator``, parsed
    by ``TreebankParser().get_trees`` (the default tagger and grammar)
    and binarized on the host (``parse_trees``: wall s and the workers'
    summed s); every node labelled with SentiWordNet's
    judgment of its words as an SST class 0-4; ``RNTN(layer_size=25,
    n_classes=5, max_nodes=64)`` at the reference's defaults fit for
    ``epochs`` at batch 32 (the p50 step on CUDA events, trees/s, the
    loss falling, root accuracy above the majority class); the card
    against the CPU (``rntn_card_vs_cpu``); ``pos_tag_viterbi`` over 200
    sentences, the card's tags equal to the CPU's; an ``InvertedIndex``
    over the sentences saved, loaded and searched alike."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import rntn as trntn
    from deeplearning4j_tpu_torch.models.convert import params_to_numpy
    from deeplearning4j_tpu_torch.text.annotator import (SentenceAnnotator,
                                                         pos_tag_viterbi)
    from deeplearning4j_tpu_torch.text.index import InvertedIndex
    from deeplearning4j_tpu_torch.text.sentiwordnet import SentiWordNet
    from deeplearning4j_tpu_torch.text.tokenization import (
        DefaultTokenizerFactory)
    from deeplearning4j_tpu_torch.text.treeparser import TreebankParser

    t_phase = time.perf_counter()
    reset_counts(wrappers)
    sents = SentenceAnnotator().annotate(" ".join(tree_corpus(np, n_sent)))
    if len(sents) != n_sent:
        fail(f"trees: the annotator split {len(sents)} sentences, not "
             f"{n_sent}")
    trees, parse_s, parse_cpu_s = parse_trees(sents)
    parser = TreebankParser()
    swn = SentiWordNet()
    for t in trees:
        for node in t.subtrees():
            node.gold_label = SST_CLASSES[swn.classify(node.words())]
    roots = np.bincount([t.gold_label for t in trees], minlength=5)
    majority = float(roots.max() / len(trees))
    rep: dict = {"card": card, "sentences": n_sent,
                 "tokens": sum(len(t.words()) for t in trees),
                 "parse_host_s": parse_s,
                 "parse_workers_s": parse_cpu_s,
                 "root_classes": roots.tolist()}

    model = trntn.RNTN(layer_size=25, n_classes=5, max_nodes=64, device=dev)
    model.build_vocab(trees)
    init = params_to_numpy(model.init())
    rep["card_vs_cpu"] = rntn_card_vs_cpu(torch, trntn, model, trees, init,
                                          cmp_steps)
    step = model._build_step()
    events = []

    def timed(params, hist, batch):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = step(params, hist, batch)
        ev[1].record()
        events.append(ev)
        return out

    model._step = timed
    t0 = time.perf_counter()
    losses = model.fit(trees, epochs=epochs, batch_size=RNTN_BATCH)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    acc = model.accuracy(trees)
    rep["fit"] = {"vocab": len(model.vocab), "epochs": epochs,
                  "steps": len(step_ms), "fit_s": fit_s,
                  "step_p50_ms": step_ms[len(step_ms) // 2],
                  "trees_per_s": len(trees) * epochs / fit_s,
                  "losses": losses, "root_accuracy": acc,
                  "majority_share": majority}
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"trees: the RNTN's loss did not fall: {losses}")
    if not acc > majority:
        fail(f"trees: root accuracy {acc} is not above the majority class "
             f"{majority}")

    # ---- Viterbi-smoothed tagging on the card against the CPU
    tf = DefaultTokenizerFactory()
    toks = [tf.create(s).get_tokens() for s in sents[:TAG_SENTENCES]]
    t0 = time.perf_counter()
    tags = [pos_tag_viterbi(t, parser.tagger, device=dev) for t in toks]
    tag_s = time.perf_counter() - t0
    if tags != [pos_tag_viterbi(t, parser.tagger, device="cpu")
                for t in toks]:
        fail("trees: pos_tag_viterbi's tags differ card vs CPU")
    rep["pos_tag_viterbi"] = {"sentences": len(toks), "s": tag_s,
                              "tags_equal_cpu": True}

    # ---- the inverted index: save, load, search alike
    ix = InvertedIndex()
    ix.add_all(sents)
    queries = ["good great love", "terrible awful hate", "the dog runs"]
    with tempfile.TemporaryDirectory(prefix="index_smoke_") as tmp:
        path = Path(tmp) / "index.jsonl.gz"
        t0 = time.perf_counter()
        ix.save(path)
        back = InvertedIndex.load(path)
        io_s = time.perf_counter() - t0
        size = path.stat().st_size
    if not (back.terms() == ix.terms()
            and all(back.search(q) == ix.search(q) for q in queries)
            and ix.search(queries[0])):
        fail("trees: the loaded index differs from the saved one")
    rep["index"] = {"docs": ix.num_documents(), "terms": len(ix.terms()),
                    "bytes": size, "save_load_s": io_s}
    rep["launches"] = _launch_free(wrappers, "trees")
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"trees: {card} | " + json.dumps(rep), flush=True)
    return rep


def _max_rel(np, got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def run_embed_plot(torch, wrappers, card, w2v, topic_words, dev="cuda"):
    """Clustering and t-SNE over ``run_text``'s negative-sampling Word2Vec
    table, with TF32 switched on for the process (``"high"``) so that
    the port's own full-float32 scopes are what keeps the distances
    exact: a distance product in that scope against float64;
    ``KMeansClustering(k=20)`` over every vector on the card (sweeps, ms a
    sweep) against the CPU from the same seed (inertia within
    ``TOL_KMEANS``, labels equal but at near ties); exact ``Tsne()`` at
    its defaults over the ``TSNE_WORDS`` most frequent words (the host's
    perplexity search, ms an iteration, the final KL; P against the
    CPU's, and ``TSNE_CMP_ITERS`` iterations from one y in float64; one
    topic's words closer in 2-D than two topics'); then
    ``render_word_vectors(model)`` at its defaults, ``/api/coords`` over
    HTTP."""
    import urllib.request

    import numpy as np

    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.observability import METRICS, TRACER
    from deeplearning4j_tpu_torch.ops.linalg import exact_f32_matmul
    from deeplearning4j_tpu_torch.plot import Tsne, render_word_vectors

    t_phase = time.perf_counter()
    reset_counts(wrappers)
    vecs = w2v.syn0.detach().float().cpu().numpy()
    spans: list = []
    listening = [True]
    TRACER.add_listener(lambda ev: listening[0] and spans.append(ev))

    def span_s(name, since):
        """Seconds in spans ``name`` recorded since ``spans[since]``."""
        return sum(sp["dur"] for sp in spans[since:]
                   if sp["name"] == name) / 1e6

    rep: dict = {"card": card, "words": vecs.shape[0], "dim": vecs.shape[1]}
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        # ---- TF32 is on; the port's scope turns it off
        a = torch.from_numpy(vecs[:4096]).to(dev)
        exact = vecs[:4096].astype(np.float64) @ vecs[:KMEANS_K].T
        tf32_err = _max_rel(np, (a @ a[:KMEANS_K].T).cpu(), exact)
        with exact_f32_matmul():
            scoped = torch.get_float32_matmul_precision()
            f32_err = _max_rel(np, (a @ a[:KMEANS_K].T).cpu(), exact)
        rep["matmul_rel_err"] = {"process_high": tf32_err,
                                 "exact_f32_scope": f32_err}
        if scoped != "highest" or not f32_err < 1e-5:
            fail(f"embed: the full-float32 scope did not hold: {scoped}, "
                 f"error {f32_err}")
        del a

        # ---- k-means over every vector
        sweeps0 = METRICS.snapshot()["counters"].get("kmeans.sweeps", 0)
        since = len(spans)
        t0 = time.perf_counter()
        km = KMeansClustering(k=KMEANS_K, device=dev).fit(vecs)
        km_s = time.perf_counter() - t0
        sweeps = METRICS.snapshot()["counters"]["kmeans.sweeps"] - sweeps0
        sweep_ms = span_s("kmeans.fit", since) * 1e3 / sweeps
        kc = KMeansClustering(k=KMEANS_K, device="cpu").fit(vecs)
        inertia_err = abs(km.inertia - kc.inertia) / kc.inertia
        diff = np.nonzero(km.labels() != kc.labels())[0]
        d2 = ((vecs[diff, None, :].astype(np.float64)
               - kc.centroids[None].astype(np.float64)) ** 2).sum(-1)
        d2.sort(axis=1)
        ties = int(((d2[:, 1] - d2[:, 0]) <= TOL_KMEANS * d2[:, 0]).sum())
        rep["kmeans"] = {"k": KMEANS_K, "points": vecs.shape[0],
                         "sweeps": sweeps, "fit_s": km_s,
                         "ms_per_sweep": sweep_ms,
                         "inertia": km.inertia, "inertia_rel_err": inertia_err,
                         "labels_differ": int(diff.size),
                         "labels_differ_at_ties": ties, "tol": TOL_KMEANS}
        if not (inertia_err < TOL_KMEANS and ties == diff.size):
            fail(f"embed: k-means differs card vs CPU: {rep['kmeans']}")

        # ---- exact t-SNE over the most frequent words
        x = vecs[:TSNE_WORDS]
        tsne = Tsne(device=dev)
        probs = {}
        input_probs = tsne._input_probs
        tsne._input_probs = lambda v: probs.setdefault("P", input_probs(v))
        since = len(spans)
        t0 = time.perf_counter()
        y = tsne.fit_transform(x)
        tsne_s = time.perf_counter() - t0
        search_s = span_s("tsne.perplexity_search", since)
        iter_ms = span_s("tsne.iterations", since) * 1e3 / tsne.n_iter
        if y.shape != (len(x), 2) or not np.isfinite(y).all():
            fail(f"embed: t-SNE gave {y.shape}, finite "
                 f"{np.isfinite(y).all()}")
        P_cpu = Tsne(device="cpu")._input_probs(x)
        p_err = _max_rel(np, probs["P"], P_cpu)
        y0 = np.random.default_rng(0).normal(0, 1e-4, (len(x), 2))
        short = {d: Tsne(n_iter=TSNE_CMP_ITERS, device=d)
                 for d in (dev, "cpu")}
        y64 = {d: m._descend(P_cpu.astype(np.float64),
                             torch.from_numpy(y0).to(d))
               for d, m in short.items()}
        y_err = _max_rel(np, y64[dev], y64["cpu"])
        y32 = short[dev]._descend(P_cpu, torch.from_numpy(
            y0.astype(np.float32)).to(dev))
        rows = [[w2v.vocab.index_of(w) for w in ws] for ws in topic_words]
        rows = [[i for i in r if 0 <= i < len(x)] for r in rows]

        def mean_dist(a, b):
            return float(np.linalg.norm(y[a][:, None] - y[b][None],
                                        axis=-1).mean())

        within = float(np.mean([mean_dist(r, r) for r in rows]))
        across = float(np.mean([mean_dist(r, rows[(i + 1) % len(rows)])
                                for i, r in enumerate(rows)]))
        rep["tsne"] = {"words": len(x), "fit_s": tsne_s,
                       "perplexity_search_host_s": search_s,
                       "search_share": search_s / tsne_s,
                       "ms_per_iteration": iter_ms, "kl": tsne.kl_,
                       "P_rel_err": p_err, "tol_P": TOL_TSNE_P,
                       f"y_f64_{TSNE_CMP_ITERS}_iters_rel_err": y_err,
                       f"y_f32_card_vs_f64_{TSNE_CMP_ITERS}_iters": _max_rel(
                           np, y32, y64["cpu"]), "tol_y": TOL_TSNE_Y,
                       "topic_within_2d": within, "topic_across_2d": across}
        if not (p_err < TOL_TSNE_P and y_err < TOL_TSNE_Y):
            fail(f"embed: t-SNE differs card vs CPU: {rep['tsne']}")
        if not within < across:
            fail(f"embed: a topic's words are not closer in 2-D "
                 f"({within}) than two topics' ({across})")

        # ---- the render server over the same model
        t0 = time.perf_counter()
        server = render_word_vectors(w2v, device=dev)
        try:
            data = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/api/coords",
                timeout=30).read())
        finally:
            server.stop()
        render_s = time.perf_counter() - t0
        if len(data) != 500 or not all(
                np.isfinite([d["x"], d["y"]]).all() for d in data):
            fail(f"embed: /api/coords served {len(data)} points")
        rep["render"] = {"points": len(data), "s": render_s}
    finally:
        torch.set_float32_matmul_precision(prev)
        listening[0] = False
    rep["launches"] = _launch_free(wrappers, "embed")
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"embed: {card} | " + json.dumps(rep), flush=True)
    return rep


# ------------------------------------------------------------------ data parallel

#: phase 15g (run_data_parallel): leg A's config at its global batch,
#: split over the ranks; one warm-up and DP_STEPS timed steps a stage
DP_BATCH, DP_SEQ = 64, 512
DP_STEPS = 2
#: the elastic leg: steps, the faults (dp 4 -> 2 at step 3, back at 4)
DP_ELASTIC_STEPS = 5
DP_ELASTIC_FAULTS = (("mesh.shrink", 3, "2"), ("mesh.grow", 4, None))
#: seconds a rank process may take (its build load, its steps)
DP_TIMEOUT_S = 420
#: SGD with momentum (the LM's default transform) at this rate: an
#: adaptive optimizer's first step is ~lr * sign(g), which turns the
#: rounding of a near-zero gradient into a whole step, so Adam makes no
#: comparison of layouts; SGD moves a weight by lr * its gradient
DP_LR = 1e-2
# the held numbers, in bf16 on the card, set from the spread measured on
# an H100 (PERF.md §6, PR 14).  Stage 1 is stage 0's reduction (one
# all-reduce of the same packed buffer, then an elementwise update of a
# chunk): held bitwise, losses and params (measured equal at dp=1 and
# dp=2, as were stages 2 and 3, whose reduce-scatter sums two ranks in
# the all-reduce's order; at more ranks it may sum in another, so they
# are held to a window: losses ~10.5, params after 4 SGD steps).  Other
# per-rank rows (dp=2 against dp=1, the elastic run's widths against the
# un-faulted dp=4 run, a checkpoint restored at another width) mean other
# GEMM shapes and bf16 roundings: measured 4.9e-5 (dp=2 vs dp=1) and
# 4.5e-5 (elastic) on the losses, held at 10x that
TOL_DP_STAGE = 1e-5
TOL_DP_PARAMS = 1e-6
TOL_DP_WIDTH = 5e-4
TOL_DP_ELASTIC = 5e-4


def dp_config(torch, ttr, cfg_kw=None):
    """Leg A's config (BERT-base: flash, fused LN, blocked xent, bf16)."""
    kw = dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12,
              d_ff=3072, max_len=512, causal=False, dtype=torch.bfloat16,
              remat=False, attention="flash", fused_ln=True,
              xent_impl="blocked")
    kw.update(cfg_kw or {})
    return ttr.TransformerConfig(**kw)


def dp_inputs(torch, ttr, cfg, dev, n_batches, batch=DP_BATCH, seq=DP_SEQ):
    """The seeded params and global batches, drawn alike on every rank."""
    model = ttr.TransformerLM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(7)
    batches = []
    for _ in range(n_batches):
        toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                             device=dev)
        batches.append((toks, torch.roll(toks, -1, dims=1)))
    return params, batches


def dp_wrappers():
    from deeplearning4j_tpu_torch.ops.cuda import attention as tat
    from deeplearning4j_tpu_torch.ops.cuda import layernorm as tln
    from deeplearning4j_tpu_torch.ops.cuda import xent as txe

    return (tat.flash_attention, tat.fused_attention,
            tln.fused_residual_layernorm, txe.blocked_cross_entropy)


def dp_stages(torch, mesh, cfg, params, batches, dev, label, stages,
              ckpt_dir=None):
    """Each stage (0-3, "hogwild") of ``DataParallelTrainer`` over
    ``mesh`` from the same params on the same global batches: one warm-up
    and DP_STEPS timed steps (CUDA events), the losses, collectives' host
    ms a step, the per-rank optimizer-state bytes, max |p - p0| against
    stage 0; with ``ckpt_dir``, stage 2 saves a checkpoint there and takes
    one more step (its loss is the restore's reference)."""
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.observability import METRICS
    from deeplearning4j_tpu_torch.optimize import transforms as TT
    from deeplearning4j_tpu_torch.parallel import (CheckpointManager,
                                                   DataParallelTrainer)
    from deeplearning4j_tpu_torch.parallel import collectives as clv
    from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves

    def loss_fn(p, x, y, gen=None):
        return ttr.lm_loss_local(p, x, y, cfg)

    out, p0 = {}, None
    rank = mesh.rank
    for stage in stages:
        METRICS.reset()
        kw = ({"router": "hogwild", "average_every": 2} if stage == "hogwild"
              else {"zero_stage": stage})
        tr = DataParallelTrainer(
            loss_fn, TT.chain(TT.momentum(0.9), TT.sgd_lr(DP_LR)), mesh=mesh,
            device=dev, **kw)
        state = tr.init_state(params)
        gauges = METRICS.snapshot()["gauges"]
        opt_bytes = next((v for k, v in gauges.items()
                          if k.startswith("train.opt_state_bytes.device.")),
                         None)
        losses, times = [], []
        for i in range(1 + DP_STEPS):
            if i == 1:
                clv.reset_stats()
            x, y = batches[i % len(batches)]
            with _dp_timer(torch, dev) as ms:
                state, lazy = tr.step(state, x, y)
                losses.append(float(lazy))
            if i:
                times.append(ms[0])
        coll = {k: dict(v) for k, v in clv.STATS.items()}
        final = tr.final_params(state)
        rep = {"losses": losses, "step_ms": times,
               "p50_step_ms": sorted(times)[len(times) // 2],
               "collective_ms_per_step": 1e3 * sum(
                   v["seconds"] for v in coll.values()) / DP_STEPS,
               "collectives": coll, "opt_state_bytes": opt_bytes,
               "host_staged": METRICS.snapshot()["counters"].get(
                   "collectives.host_staged", 0)}
        rep["tokens_per_s"] = DP_BATCH * DP_SEQ / (rep["p50_step_ms"] / 1e3)
        if stage == 0:
            p0 = [t.detach().float().clone() for t in tree_leaves(final)]
        else:
            rep["max_param_diff_vs_stage0"] = max(
                (a.float() - b).abs().max().item()
                for a, b in zip(tree_leaves(final), p0))
        if stage == 2 and ckpt_dir is not None:
            mgr = CheckpointManager(ckpt_dir, keep=1)
            t0 = time.perf_counter()
            tr.checkpoint(state, mgr)
            rep["save_s"] = time.perf_counter() - t0
            x, y = batches[(1 + DP_STEPS) % len(batches)]
            state, lazy = tr.step(state, x, y)
            rep["next_loss"] = float(lazy)
        out[str(stage)] = rep
        if rank == mesh.ranks[0]:
            print(f"{label} stage {stage}: p50_step_ms="
                  f"{rep['p50_step_ms']:.2f} tokens_per_s="
                  f"{rep['tokens_per_s']:.1f} collective_ms_per_step="
                  f"{rep['collective_ms_per_step']:.2f} host_staged="
                  f"{rep['host_staged']} losses="
                  f"{[round(v, 5) for v in losses]}", flush=True)
        del tr, state, final
        torch.cuda.empty_cache()
    return out


def _counts(wrappers) -> dict:
    return {w.__name__: w.launches for w in wrappers}


@contextlib.contextmanager
def _dp_timer(torch, dev):
    """Milliseconds of the body: CUDA events on the card (the body ends
    in a host read, so the end event follows its work), the host clock
    elsewhere; the value lands in the yielded list."""
    out = []
    if torch.device(dev).type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        yield out
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1))
    else:
        t = time.perf_counter()
        yield out
        out.append(1e3 * (time.perf_counter() - t))


def _peak_gb(torch, dev) -> float:
    if torch.device(dev).type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated() / 2 ** 30


#: a spawned rank's pipe to the parent (``report_progress``)
_RANK_CONN = None


def report_progress(msg) -> None:
    """From a spawned rank: tell the parent ``msg`` before the job ends
    (``spawn_ranks``' ``on_progress``)."""
    if _RANK_CONN is not None:
        _RANK_CONN.send(("progress", msg))


def dp_rank_main(rank, world, store, conn, job, kwargs):
    """A spawned rank of phases 15g/15h: join the gloo group on
    ``cuda:0``, run ``job`` and send its result (or the traceback) to the
    parent; with ``nccl_first``, first ask for NCCL and keep its
    refusal."""
    import traceback

    global _RANK_CONN
    _RANK_CONN = conn
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    try:
        import torch

        if torch.device(kwargs.get("dev", "cuda")).type == "cuda":
            torch.cuda.set_device(0)
        from deeplearning4j_tpu_torch.parallel import mesh as pmesh

        refusal = None
        if kwargs.pop("nccl_first", False):
            # these ranks share one card: NCCL must refuse them, loudly
            try:
                pmesh.initialize_multihost(f"file://{store}.nccl", world,
                                           rank, backend="nccl",
                                           timeout_s=DP_TIMEOUT_S)
                refusal = "NCCL accepted two ranks on one GPU"
                pmesh.shutdown_multihost()
            except RuntimeError as e:
                refusal = str(e)
        pmesh.initialize_multihost(f"file://{store}", world, rank,
                                   backend="gloo", timeout_s=DP_TIMEOUT_S)
        try:
            out = globals()[job](torch, rank, world, **kwargs)
            if refusal is not None:
                out["nccl_refusal"] = refusal
            conn.send(("ok", out))
        finally:
            pmesh.shutdown_multihost()
    except Exception:       # the rank's boundary: reported to the parent
        conn.send(("err", f"rank {rank}:\n{traceback.format_exc()}"))


def spawn_ranks(world, job, label, on_progress=None, **kwargs) -> list:
    """``job`` in ``world`` spawned rank processes sharing one card over
    gloo; their results in rank order (``on_progress(rank, msg)`` takes
    what a rank reports before it ends).  Any failure, or a rank not done
    within DP_TIMEOUT_S, kills every rank and fails the run."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dl4j_dp_") as tmp:
        procs, conns = [], []
        for r in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=dp_rank_main,
                            args=(r, world, str(Path(tmp) / "store"), child,
                                  job, dict(kwargs)), daemon=True)
            p.start()
            procs.append(p)
            conns.append(parent)
        deadline = time.monotonic() + DP_TIMEOUT_S
        results, errors = [], []
        try:
            for r, c in enumerate(conns):
                kind = "progress"
                while kind == "progress":
                    if not c.poll(max(0.0, deadline - time.monotonic())):
                        kind, value = "err", (f"rank {r} not done in "
                                              f"{DP_TIMEOUT_S} s")
                        break
                    try:
                        kind, value = c.recv()
                    except EOFError:
                        kind, value = "err", f"rank {r} died"
                    if kind == "progress" and on_progress is not None:
                        on_progress(r, value)
                (errors if kind == "err" else results).append(value)
                if kind == "err" and "not done" in value:
                    break
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        fail(f"{label}: " + "\n".join(errors))
    return results


def dp_width_job(torch, rank, world, ckpt_dir, cfg_kw=None, dev="cuda"):
    """dp=``world`` over gloo: the stages and hogwild, and a ZeRO-2
    checkpoint into ``ckpt_dir``; this rank's launches."""
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.parallel.mesh import local_mesh

    wrappers = dp_wrappers()
    cfg = dp_config(torch, ttr, cfg_kw)
    params, batches = dp_inputs(torch, ttr, cfg, dev, 1 + DP_STEPS + 1)
    reset_counts(wrappers)
    rep = dp_stages(torch, local_mesh(), cfg, params, batches, dev,
                    f"dp={world} gloo", (0, 1, 2, 3, "hogwild"), ckpt_dir)
    from deeplearning4j_tpu_torch.analysis.shardguard import SHARDGUARD

    return {"stages": rep, "launches": _counts(wrappers),
            "peak_mem_gb": _peak_gb(torch, dev),
            "shardguard": {"enabled": SHARDGUARD.enabled,
                           "violations": len(SHARDGUARD.violations())}}


def dp_elastic_job(torch, rank, world, root, cfg_kw=None, dev="cuda",
                   mp=None):
    """The supervised elastic run over every rank (ZeRO-1; dp 4 -> 2 -> 4
    by DP_ELASTIC_FAULTS) and the un-faulted fit before it; the launches
    split by the width they ran at (the factory snapshots the counts).
    With ``mp`` (``MPRun.job_kwargs``) the same ranks then run phase
    15h's ``mp_rank_job``, whose result is under "mp"."""
    import glob

    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.observability import FLIGHTREC, METRICS
    from deeplearning4j_tpu_torch.optimize import transforms as TT
    from deeplearning4j_tpu_torch.parallel import (CheckpointManager,
                                                   DataParallelTrainer,
                                                   elastic_mesh)
    from deeplearning4j_tpu_torch.parallel.mesh import rank_devices
    from deeplearning4j_tpu_torch.resilience import (FaultSpec, RetryPolicy,
                                                     TrainingSupervisor,
                                                     inject_faults)

    wrappers = dp_wrappers()
    cfg = dp_config(torch, ttr, cfg_kw)
    params, data = dp_inputs(torch, ttr, cfg, dev, DP_ELASTIC_STEPS)
    reset_counts(wrappers)
    by_width: dict = {}
    current = {"width": None, "at": _counts(wrappers)}

    def settle():
        now = _counts(wrappers)
        if current["width"] is not None:
            acc = by_width.setdefault(current["width"], dict.fromkeys(now, 0))
            for k in now:
                acc[k] += now[k] - current["at"][k]
        current["at"] = now

    def factory(devices):
        devs = devices if devices is not None else rank_devices()
        settle()
        current["width"] = len(devs)
        return DataParallelTrainer(
            lambda p, x, y, gen=None: ttr.lm_loss_local(p, x, y, cfg),
            TT.chain(TT.momentum(0.9), TT.sgd_lr(DP_LR)),
            mesh=elastic_mesh(devs), zero_stage=1, device=dev)

    ref = factory(None)
    t0 = time.perf_counter()
    _, ref_losses = ref.fit(ref.init_state(params), data)
    ref_s = time.perf_counter() - t0
    del ref
    torch.cuda.empty_cache()
    root = Path(root)
    sup = TrainingSupervisor(CheckpointManager(root / "ckpt", keep=10),
                             RetryPolicy(max_attempts=4, backoff_base_s=0.01),
                             install_signal_handlers=False)
    FLIGHTREC.dump_dir = root / f"rec{rank}"
    METRICS.reset()
    specs = [FaultSpec(s, at_step=a, kind=k) for s, a, k in DP_ELASTIC_FAULTS]
    t0 = time.perf_counter()
    with inject_faults(*specs, seed=0):
        state, _ = sup.fit(factory, params, data, epochs=1,
                           checkpoint_every=2)
    fit_s = time.perf_counter() - t0
    settle()
    rebuild = []
    for path in sorted(glob.glob(str(FLIGHTREC.dump_dir /
                                      "flightrec-mesh_resize-*.json"))):
        extra = json.loads(Path(path).read_text()).get("extra", {})
        rebuild.append((extra.get("direction"), extra.get("rebuild_seconds")))
    snap = METRICS.snapshot()
    out = {"step": int(state.step), "ref_losses": ref_losses,
           "losses_by_step": {int(k): v for k, v in
                              sup.report.losses_by_step.items()},
           "mesh_sizes": list(sup.report.mesh_sizes),
           "member": sup.trainer.member, "ref_fit_s": ref_s,
           "supervised_fit_s": fit_s, "rebuild_s": rebuild,
           "reshard_s": snap["gauges"].get("elastic.reshard_seconds"),
           "restore_s": snap["timers"].get("checkpoint.restore", {}),
           "launches_by_width": by_width,
           "peak_mem_gb": _peak_gb(torch, dev)}
    if mp is not None:
        del sup, state, data, params
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        out["mp"] = mp_rank_job(torch, rank, world, **mp)
    return out


def dp_hold_stages(rep, label) -> None:
    """Stage 1 bitwise stage 0 (the same reduction); stages 2-3 within
    TOL_DP_STAGE (losses) and TOL_DP_PARAMS (params)."""
    for stage in ("1", "2", "3"):
        d = max(abs(a - b) for a, b in zip(rep[stage]["losses"],
                                           rep["0"]["losses"]))
        pd = rep[stage]["max_param_diff_vs_stage0"]
        tol, ptol = (0.0, 0.0) if stage == "1" else (TOL_DP_STAGE,
                                                     TOL_DP_PARAMS)
        if d > tol or pd > ptol:
            fail(f"15g {label}: stage {stage} off stage 0 by {d} (losses, "
                 f"tol {tol}), {pd} (params, tol {ptol})")


def run_data_parallel(torch, wrappers, card, dev="cuda", cfg_kw=None,
                      backend="nccl", expect_launches=True, mp=None):
    """Phase 15g: the data-parallel tier at leg A's full width.

    1. one rank in this process over ``backend`` (NCCL on the card):
       ZeRO stages 0-3 and hogwild through ``DataParallelTrainer``, then
       ``TransformerLM(cfg, mesh).build_train_step(zero1=True)`` against
       ``zero1=False`` — every collective a real call of the backend;
    2. NCCL refusing two ranks on one GPU (the two spawned ranks of 3.
       ask for it first);
    3. dp=2: two spawned ranks on the card over gloo: the stages and
       hogwild, each stage against stage 0 and stage 0 against dp=1, the
       per-rank optimizer-state bytes, a ZeRO-2 checkpoint written at
       dp=2 and restored here at dp=1 (its next loss held);
    4. the elastic run over four spawned ranks: ``TrainingSupervisor.fit``
       over a trainer factory, ``mesh.shrink`` losing 2 ranks at step 3
       and ``mesh.grow`` taking them back at step 4, every recovered loss
       within TOL_DP_ELASTIC of the un-faulted run.

    Launches of #1/#3/#4 are counted per rank and returned as legs at the
    per-rank rows they ran (the kernels line's weights).  With ``mp`` (an
    ``MPRun``) the four elastic ranks then run phase 15h's legs: their
    results are under "mp_ranks" and their seconds under "mp_s", not in
    this phase's."""
    from deeplearning4j_tpu_torch.analysis.shardguard import (ENV_SHARDGUARD,
                                                              SHARDGUARD)
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.observability import METRICS
    from deeplearning4j_tpu_torch.optimize import transforms as TT
    from deeplearning4j_tpu_torch.parallel import (CheckpointManager,
                                                   DataParallelTrainer)
    from deeplearning4j_tpu_torch.parallel import collectives as clv
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    cfg = dp_config(torch, ttr, cfg_kw)
    rep: dict = {"config": str(cfg), "global_batch": [DP_BATCH, DP_SEQ]}
    # ---- 1. one rank, this process
    tmp = tempfile.mkdtemp(prefix="dl4j_dp_")
    try:
        pmesh.initialize_multihost(f"file://{tmp}/store", 1, 0,
                                   backend=backend, timeout_s=DP_TIMEOUT_S)
        mesh = pmesh.local_mesh()
        rep["backend_one_rank"] = pmesh.backend()
        params, batches = dp_inputs(torch, ttr, cfg, dev, 1 + DP_STEPS + 1)
        reset_counts(wrappers)
        SHARDGUARD.reset()             # the stages' dispatches, checked
        SHARDGUARD.enable()
        one = dp_stages(torch, mesh, cfg, params, batches, dev,
                        f"dp=1 {backend}", (0, 1, 2, 3, "hogwild"))
        SHARDGUARD.disable()
        rep["shardguard_dp1"] = len(SHARDGUARD.violations())
        if rep["shardguard_dp1"]:
            fail(f"15g dp=1: {SHARDGUARD.report()}")
        model = ttr.TransformerLM(cfg, mesh, device=dev)
        z1 = {}
        for zero1 in (False, True):
            tx = TT.chain(TT.momentum(0.9), TT.sgd_lr(DP_LR))
            step = model.build_train_step(tx, zero1=zero1)
            opt = (model.init_opt_zero1(params, tx) if zero1
                   else model.init_opt(params, tx))
            p, losses = params, []
            clv.reset_stats()
            for x, y in batches[:1 + DP_STEPS]:
                p, opt, loss = step(p, opt, x, y)
                losses.append(loss.item())
            z1[str(zero1)] = {"losses": losses, "collectives": {
                k: dict(v) for k, v in clv.STATS.items()}}
            del p, opt, step
        rep["lm_zero1"] = z1
        gap = max(abs(a - b) for a, b in zip(z1["True"]["losses"],
                                             z1["False"]["losses"]))
        calls = {k: v["calls"] for k, v in z1["True"]["collectives"].items()}
        print(f"dp=1 {backend} TransformerLM zero1 losses="
              f"{[round(v, 5) for v in z1['True']['losses']]} vs replicated"
              f" max |diff|={gap:.3g} collective calls={calls}", flush=True)
        if gap > TOL_DP_STAGE:
            fail(f"15g: zero1 step off the replicated one by {gap}")
        rep["one_rank"] = one
        dp_hold_stages(one, "dp=1")
        if backend == "nccl" and not all(
                s.get("calls") for s in one["2"]["collectives"].values()):
            fail(f"15g dp=1: no NCCL collective ran: {one['2']}")
        del params, batches
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()

        # ---- 2./3. two ranks on the card: NCCL refuses them; dp=2 over
        # gloo, and the checkpoint back at dp=1 here
        ckpt = Path(tmp) / "zero2"
        on_card = torch.device(dev).type == "cuda"
        os.environ[ENV_SHARDGUARD] = "1"   # the ranks guard their steps
        try:
            two = spawn_ranks(2, "dp_width_job", "15g dp=2",
                              ckpt_dir=str(ckpt), cfg_kw=cfg_kw, dev=dev,
                              nccl_first=on_card)
        finally:
            os.environ.pop(ENV_SHARDGUARD, None)
        guarded = [r["shardguard"] for r in two]
        if not all(g["enabled"] and g["violations"] == 0 for g in guarded):
            fail(f"15g dp=2: shardguard on the ranks {guarded}")
        print(f"15g shardguard: dp=1 stages {rep['shardguard_dp1']} "
              f"violations; dp=2 ranks {[g['violations'] for g in guarded]}"
              f" violations (enabled from {ENV_SHARDGUARD}=1)", flush=True)
        if on_card:
            msgs = [r["nccl_refusal"] for r in two]
            if not all("NCCL cannot run several ranks on one GPU" in m
                       for m in msgs):
                fail(f"15g: NCCL did not refuse two ranks on one GPU: "
                     f"{msgs}")
            rep["nccl_two_ranks_refused"] = msgs[0]
            print(f"dp=2 nccl: refused on both ranks ({msgs[0][:60]}...)",
                  flush=True)
        st2 = two[0]["stages"]
        dp_hold_stages(st2, "dp=2")
        wd = max(abs(a - b) for a, b in zip(st2["0"]["losses"],
                                            one["0"]["losses"]))
        hd = abs(st2["hogwild"]["losses"][0] - st2["0"]["losses"][0])
        if wd > TOL_DP_WIDTH or hd > TOL_DP_WIDTH:
            fail(f"15g: dp=2 off dp=1 by {wd}, hogwild's first loss by {hd}")
        shrink = [r["stages"]["2"]["opt_state_bytes"]
                  / r["stages"]["0"]["opt_state_bytes"] for r in two]
        if not all(0.5 <= s <= 0.5 + 1e-3 for s in shrink):
            fail(f"15g dp=2: optimizer-state bytes at stage 2 / stage 0 = "
                 f"{shrink}, not ~1/2")
        METRICS.reset()
        tr = DataParallelTrainer(
            lambda p, x, y, gen=None: ttr.lm_loss_local(p, x, y, cfg),
            TT.chain(TT.momentum(0.9), TT.sgd_lr(DP_LR)), mesh=mesh,
            zero_stage=2, device=dev)
        params, batches = dp_inputs(torch, ttr, cfg, dev, 1 + DP_STEPS + 1)
        t0 = time.perf_counter()
        state = tr.restore(tr.init_state(params), CheckpointManager(ckpt))
        restore_s = time.perf_counter() - t0
        x, y = batches[(1 + DP_STEPS) % len(batches)]
        state, lazy = tr.step(state, x, y)
        next_loss = float(lazy)
        want = st2["2"]["next_loss"]
        resharded = METRICS.snapshot()["counters"].get("checkpoint.reshards")
        if abs(next_loss - want) > TOL_DP_WIDTH or not resharded:
            fail(f"15g: ZeRO-2 dp=2 checkpoint restored at dp=1 steps to "
                 f"{next_loss}, dp=2 to {want} (reshards {resharded})")
        # this process's launches: leg 1 and the restored step, all at
        # the global batch on one rank
        launches_one = _counts(wrappers)
        del tr, state, params, batches
        torch.cuda.empty_cache()
        rep["dp2"] = {"stages": st2, "opt_state_shrink": shrink,
                      "launches_per_rank": [r["launches"] for r in two],
                      "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in two],
                      "dp2_vs_dp1_max_loss_diff": wd,
                      "ckpt_save_s": st2["2"].get("save_s"),
                      "ckpt_restore_dp1_s": restore_s,
                      "ckpt_next_loss": [want, next_loss]}
        print(f"dp=2 gloo: stage 1 bitwise stage 0, 2-3 within "
              f"{TOL_DP_STAGE}, dp=2 vs "
              f"dp=1 max |loss diff|={wd:.3g}, opt-state bytes stage2/stage0"
              f"={[round(s, 5) for s in shrink]}, zero2 checkpoint save_s="
              f"{st2['2'].get('save_s', 0):.2f} restore at dp=1 s="
              f"{restore_s:.2f} next loss {next_loss:.5f} vs {want:.5f}, "
              f"peak_mem_gb={rep['dp2']['peak_mem_gb_per_rank']}", flush=True)

        # ---- 4. the elastic run over four ranks
        four = spawn_ranks(
            4, "dp_elastic_job", "15g elastic",
            on_progress=mp.on_progress if mp is not None else None,
            root=str(Path(tmp) / "elastic"), cfg_kw=cfg_kw, dev=dev,
            mp=mp.job_kwargs if mp is not None else None)
        if mp is not None:
            rep["mp_ranks"] = [r.pop("mp") for r in four]
            rep["mp_s"] = rep["mp_ranks"][0]["s"]
        e0 = four[0]
        win = max(abs(v - e0["ref_losses"][s - 1])
                  for s, v in e0["losses_by_step"].items())
        if e0["step"] != DP_ELASTIC_STEPS or e0["mesh_sizes"] != [2, 4] \
                or not all(r["member"] for r in four) or win > TOL_DP_ELASTIC:
            fail(f"15g elastic: step {e0['step']}, sizes {e0['mesh_sizes']}, "
                 f"members {[r['member'] for r in four]}, window {win}")
        rep["elastic"] = {k: e0[k] for k in (
            "ref_losses", "losses_by_step", "mesh_sizes", "ref_fit_s",
            "supervised_fit_s", "rebuild_s", "reshard_s", "restore_s")}
        rep["elastic"]["window"] = win
        rep["elastic"]["peak_mem_gb_per_rank"] = [r["peak_mem_gb"]
                                                  for r in four]
        print(f"elastic dp 4->2->4 gloo: window={win:.3g} (tol "
              f"{TOL_DP_ELASTIC}) un-faulted fit s={e0['ref_fit_s']:.2f} "
              f"supervised fit s={e0['supervised_fit_s']:.2f} rebuild s="
              f"{e0['rebuild_s']} reshard s={e0['reshard_s']} peak_mem_gb="
              f"{rep['elastic']['peak_mem_gb_per_rank']}", flush=True)
    finally:
        pmesh.shutdown_multihost()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    # the legs of the kernels line: launches summed over the ranks, at the
    # rows each rank ran
    def leg(batch, launches):
        return {"batch": batch, "seq": DP_SEQ, "causal": cfg.causal,
                "launches": launches}

    names = [w.__name__ for w in wrappers]
    legs = [leg(DP_BATCH, launches_one)]
    legs.append(leg(DP_BATCH // 2, {k: sum(r["launches"].get(k, 0)
                                          for r in two) for k in names}))
    for width in (4, 2):
        legs.append(leg(DP_BATCH // width, {k: sum(
            r["launches_by_width"].get(width, {}).get(k, 0) for r in four)
            for k in names}))
    total = {k: sum(lg["launches"][k] for lg in legs) for k in names}
    for k in ("flash_attention", "fused_residual_layernorm",
              "blocked_cross_entropy"):
        if expect_launches and total[k] <= 0:
            fail(f"15g: {k} was not launched: {total}")
    rep["legs"] = legs
    rep["launches"] = total
    rep["phase_s"] = time.perf_counter() - t_phase - rep.get("mp_s", 0.0)
    print(f"data parallel: {card} | phase_s={rep['phase_s']:.1f} "
          f"launches={total}", flush=True)
    return rep


#: phase 15h (run_model_parallel): the model-parallel axes at the
#: flagship's full width, four ranks sharing the card over gloo.  Each LM
#: leg: label -> (mesh, global batch, seq, micro-batches); one warm-up and
#: MP_STEPS timed steps, SGD with momentum at DP_LR, as 15g
MP_STEPS = 2
MP_LEGS = {"tp": (dict(dp=2, tp=2), 16, 512, 0),
           "sp": (dict(dp=1, sp=2, tp=2), 4, 2048, 0),
           "pp": (dict(dp=2, pp=2), 8, 2048, 4)}
#: the ep leg: a seeded topic corpus (tokens, words): ~7.4k words seen,
#: so each of the four shards owns ~1.9k rows; every batch ships its rows
#: by gloo all-reduces through host memory (~8 ms each on one card), so
#: the fits are kept small: Word2Vec window 2, GloVe window 3, one pass
MP_EP_TOKENS, MP_EP_VOCAB = 50_000, 10_000
#: the held numbers, bf16 on the card, set from the spread measured on an
#: H100 (PERF.md §6).  A mesh step against the one-device step on the
#: same global batch: other GEMM shapes (heads or FFN columns split over
#: tp, a sequence split over sp, micro-batches of one row in the
#: pipeline) round bf16 otherwise, as 15g's widths do: measured 4.4e-5
#: to 6.2e-5 on the losses (~10.55) and 1.4e-6 to 3.4e-6 on the params
#: (after 3 SGD steps), held at ~10x that.  ZeRO-1 against the
#: replicated pipelined step (the same reduction but for the dp
#: reduce-scatter, measured 0): TOL_DP_STAGE / TOL_DP_PARAMS.  The ep
#: leg's fits in float32 against one device (the same batches, draws and
#: ordered scatter-adds, plus zeros from the rows a shard does not own):
#: measured 0 (Word2Vec) and 3e-8 to 6e-8 (GloVe)
TOL_MP_LOSS = 6e-4
TOL_MP_PARAMS = 3e-5
TOL_MP_EP = 1e-6


def mp_config(torch, ttr, label, cfg_kw=None):
    """The tp leg: leg A's config; sp: the default causal config (T=2048,
    remat) with ring attention; pp: leg B's (fused attention and LN)."""
    if label == "tp":
        return dp_config(torch, ttr, cfg_kw)
    kw = dict(fused_ln=True, xent_impl="blocked",
              attention="ring" if label == "sp" else "fused")
    kw.update(cfg_kw or {})
    return ttr.TransformerConfig(**kw)


def _max_diff(torch, got, want) -> float:
    from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves

    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _one_device(torch, ttr, cfg, params, batches, dev, opt=None):
    """The same config's one-device steps on the global batches: (losses,
    params)."""
    from deeplearning4j_tpu_torch.optimize import transforms as TT

    solo = ttr.TransformerLM(cfg, device=dev)
    tx = TT.chain(TT.momentum(0.9), TT.sgd_lr(DP_LR))
    step = solo.build_train_step(tx)
    opt = opt if opt is not None else solo.init_opt(params, tx)
    losses = []
    for x, y in batches:
        params, opt, loss = step(params, opt, x, y)
        losses.append(loss.item())
    return losses, params


def mp_lm_leg(torch, label, wrappers, dev, cfg_kw=None, ckpt_dir=None):
    """One LM leg of 15h on every rank: the mesh steps (timed), this
    rank's launches, the collectives by axis; the params gathered, and on
    the first rank the one-device steps they are held to.  The pp leg
    adds its ZeRO-1 step (against the replicated one) and a checkpoint of
    the ZeRO-1 state written from the mesh, restored into a one-device
    ``TransformerLM`` whose next loss is held to the mesh's."""
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.models.pipeline import (
        PipelinedTransformerLM, stack_layers, unstack_layers,
        zero1_state_to_natural)
    from deeplearning4j_tpu_torch.observability import METRICS
    from deeplearning4j_tpu_torch.optimize import transforms as TT
    from deeplearning4j_tpu_torch.parallel import CheckpointManager
    from deeplearning4j_tpu_torch.parallel import collectives as clv
    from deeplearning4j_tpu_torch.parallel.checkpoint import save_sharded
    from deeplearning4j_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                        rank_devices,
                                                        world_rank)

    spec, batch, seq, n_micro = MP_LEGS[label]
    cfg = mp_config(torch, ttr, label, cfg_kw)
    mesh = make_mesh(MeshSpec(**spec), devices=rank_devices()[:4])
    model = (PipelinedTransformerLM(cfg, mesh, n_micro=n_micro, device=dev)
             if n_micro else ttr.TransformerLM(cfg, mesh, device=dev))
    params, batches = dp_inputs(torch, ttr, cfg, dev, 2 + MP_STEPS,
                                batch=batch, seq=seq)
    init = stack_layers(params) if n_micro else params
    tx = TT.chain(TT.momentum(0.9), TT.sgd_lr(DP_LR))
    unstack = ((lambda t: unstack_layers(t, cfg.n_layers)) if n_micro
               else (lambda t: t))

    def run(zero1):
        tree = model.place(init)
        opt = (model.init_opt_zero1(tree, tx) if zero1
               else model.init_opt(tree, tx))
        step = model.build_train_step(tx, zero1=zero1)
        losses, times = [], []
        for i in range(1 + MP_STEPS):
            if i == 1:
                clv.reset_stats()
                METRICS.reset()
            x, y = batches[i]
            with _dp_timer(torch, dev) as ms:
                tree, opt, loss = step(tree, opt, x, y)
                losses.append(loss.item())
            if i:
                times.append(ms[0])
        return tree, opt, step, losses, times

    reset_counts(wrappers)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tree, _, _, losses, times = run(False)
    coll = {k: dict(v) for k, v in clv.STATS.items()}
    staged = METRICS.snapshot()["counters"].get("collectives.host_staged", 0)
    p50 = sorted(times)[len(times) // 2]
    rep = {"mesh": spec, "global_batch": [batch, seq], "n_micro": n_micro,
           "config": str(cfg), "losses": losses, "step_ms": times,
           "p50_step_ms": p50, "tokens_per_s": batch * seq / (p50 / 1e3),
           "collective_ms_per_step": 1e3 * sum(
               v["seconds"] for v in coll.values()) / MP_STEPS,
           "collectives": coll,
           "collectives_by_axis": {a: {**v, "ms_per_step": 1e3 * v["seconds"]
                                       / MP_STEPS}
                                   for a, v in clv.AXIS_STATS.items()},
           "host_staged_per_step": staged / MP_STEPS}
    whole = model.gather(tree)
    del tree
    nxt = None
    if n_micro:
        z_tree, z_opt, z_step, z_losses, _ = run(True)
        z_whole = model.gather(z_tree)
        rep["zero1_losses"] = z_losses
        rep["zero1_vs_replicated"] = [
            max(abs(a - b) for a, b in zip(z_losses, losses)),
            _max_diff(torch, z_whole, whole)]
        t0 = time.perf_counter()
        save_sharded(CheckpointManager(ckpt_dir, keep=1), model,
                     1 + MP_STEPS, z_tree, z_opt, model._specs(),
                     model.opt_specs_zero1(tx))
        rep["ckpt_save_s"] = time.perf_counter() - t0
        x, y = batches[1 + MP_STEPS]
        _, _, nxt = z_step(z_tree, z_opt, x, y)
        rep["zero1_next_loss"] = nxt = nxt.item()
        del z_tree, z_opt, z_whole
    rep["launches"] = _counts(wrappers)
    rep["peak_mem_gb"] = _peak_gb(torch, dev)
    if world_rank() == 0:
        # the one-device steps on the same global batches (their launches
        # are not the leg's)
        ref_losses, ref = _one_device(torch, ttr, cfg, params,
                                      batches[:1 + MP_STEPS], dev)
        rep["vs_one_device"] = [
            max(abs(a - b) for a, b in zip(losses, ref_losses)),
            _max_diff(torch, unstack(whole), ref)]
        rep["one_device_losses"] = ref_losses
        del ref
        if n_micro:
            t0 = time.perf_counter()
            z1, _ = model._z1_template_and_specs(whole, model._specs())
            r = CheckpointManager(ckpt_dir).restore(whole, (0, tx.init(z1)))
            count, st = zero1_state_to_natural(model, tx, r["tstate"],
                                               r["params"])
            st = tuple(unstack(s) if isinstance(s, dict) else s for s in st)
            loss, _ = _one_device(torch, ttr, cfg, unstack(r["params"]),
                                  batches[1 + MP_STEPS:], dev,
                                  opt=(count, st))
            rep["ckpt_restore_one_device_s"] = time.perf_counter() - t0
            rep["ckpt_next_loss"] = [nxt, loss[0]]
            del z1, r, st
    del whole, params, batches
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return rep


def mp_ep_leg(torch, dev, n_tokens=MP_EP_TOKENS, vocab=MP_EP_VOCAB):
    """``ShardedWord2Vec`` (HS, then NS) and ``ShardedGlove`` over ep=4,
    and on the first rank the one-device fits they are held to."""
    import numpy as np

    from deeplearning4j_tpu_torch.parallel import collectives as clv
    from deeplearning4j_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                        rank_devices,
                                                        world_rank)
    from deeplearning4j_tpu_torch.text.glove import Glove
    from deeplearning4j_tpu_torch.text.sharded_embedding import (
        ShardedGlove, ShardedWord2Vec, pad_rows)
    from deeplearning4j_tpu_torch.text.word2vec import Word2Vec

    sents, _, _ = topic_corpus(np, n_tokens=n_tokens, vocab=vocab)
    mesh = make_mesh(MeshSpec(dp=1, ep=4), devices=rank_devices()[:4])
    w2v = dict(layer_size=64, window=2, sample=1e-3, seed=1,
               batch_size=4096)
    runs = (("word2vec_hs", ShardedWord2Vec, Word2Vec, dict(w2v)),
            ("word2vec_ns", ShardedWord2Vec, Word2Vec,
             dict(w2v, negative=5, use_hierarchic_softmax=False)),
            ("glove", ShardedGlove, Glove,
             dict(layer_size=32, window=3, iterations=1, seed=1)))
    rep = {}
    for label, sharded, solo, kw in runs:
        clv.reset_stats()
        t0 = time.perf_counter()
        m = sharded(sents, mesh=mesh, device=dev, **kw).fit()
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        out = {"fit_s": time.perf_counter() - t0, "vocab": len(m.vocab),
               "rows_per_shard": pad_rows(len(m.vocab), 4) // 4,
               "collectives_by_axis": {a: dict(v) for a, v in
                                       clv.AXIS_STATS.items()}}
        emb = m.syn0[:len(m.vocab)]
        if world_rank() == 0:
            one = solo(sents, device=dev, **kw).fit()
            out["vs_one_device"] = (emb - one.syn0[:len(one.vocab)]
                                    ).abs().max().item()
        rep[label] = out
    return rep


def mp_rank_job(torch, rank, world, ckpt_dir, cfg_kw=None, dev="cuda",
                ep_tokens=MP_EP_TOKENS):
    """A rank of phase 15h: the tp, sp and pp legs, then the ep leg."""
    t0 = time.perf_counter()
    wrappers = dp_wrappers()
    out = {label: mp_lm_leg(torch, label, wrappers, dev, cfg_kw,
                            ckpt_dir=ckpt_dir if label == "pp" else None)
           for label in MP_LEGS}
    if rank == 0:
        report_progress("lm_done")
    out["ep"] = mp_ep_leg(torch, dev, n_tokens=ep_tokens)
    out["s"] = time.perf_counter() - t0
    return out


class MPRun:
    """Phase 15h's state between its ranks' start and its report: the
    rank job's keyword arguments, the dryrun subprocess (started when the
    first rank reports its LM legs done, beside the ep leg) and a
    temporary directory for the pipeline's checkpoint."""

    def __init__(self, root=ROOT, dev="cuda", cfg_kw=None, dryrun=True,
                 ep_tokens=MP_EP_TOKENS):
        self.root, self.dev, self.dryrun = root, dev, dryrun
        self.tmp = tempfile.mkdtemp(prefix="dl4j_mp_")
        self.job_kwargs = dict(ckpt_dir=str(Path(self.tmp) / "pp_zero1"),
                               cfg_kw=cfg_kw, dev=dev, ep_tokens=ep_tokens)
        self.proc, self.t_dryrun = None, None

    def on_progress(self, rank, msg) -> None:
        if self.dryrun and msg == "lm_done" and self.proc is None:
            self.t_dryrun = time.perf_counter()
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "deeplearning4j_tpu_torch", "dryrun",
                 "--devices", "8", "--platform", self.dev],
                cwd=str(self.root), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)

    def close(self) -> None:
        """Stop the dryrun if it still runs; remove the directory."""
        import shutil

        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        shutil.rmtree(self.tmp, ignore_errors=True)


def run_model_parallel(torch, wrappers, card, root=ROOT, dev="cuda",
                       cfg_kw=None, expect_launches=True, dryrun=True,
                       ep_tokens=MP_EP_TOKENS):
    """Phase 15h alone: four spawned ranks run ``mp_rank_job``, then
    :func:`mp_report` (in the whole script the ranks of 15g's elastic leg
    run it, which saves a start-up)."""
    t0 = time.perf_counter()
    run = MPRun(root, dev, cfg_kw, dryrun, ep_tokens)
    try:
        ranks = spawn_ranks(4, "mp_rank_job", "15h",
                            on_progress=run.on_progress, **run.job_kwargs)
        return mp_report(torch, wrappers, card, ranks, run,
                         time.perf_counter() - t0, expect_launches)
    finally:
        run.close()


def mp_report(torch, wrappers, card, ranks, run, ranks_s,
              expect_launches=True):
    """Phase 15h: the model-parallel axes at the flagship's full width.

    Four ranks sharing the card over gloo ran MP_LEGS (``mp_rank_job``,
    ``ranks_s`` seconds): tensor parallel (leg A's config, dp2·tp2, #1 on
    6 local heads), sequence parallel (ring attention over sp2·tp2, 1024
    positions a rank) and the GPipe pipeline (leg B's config, pp2·dp2, 4
    micro-batches of one row; its ZeRO-1 step against the replicated
    one, and a checkpoint of the ZeRO-1 state from the mesh restored into
    a one-device ``TransformerLM``), each held here against the same
    config's one-device step on the same global batch; then
    ``ShardedWord2Vec`` (HS, NS) and ``ShardedGlove`` over ep=4 against
    the one-device fits, beside ``python -m deeplearning4j_tpu_torch
    dryrun --devices 8`` (eight more ranks on the card), whose exit and
    OK line are held.  Each leg's launches of #1-#4, summed over the
    ranks, join the kernels line at the shapes a rank ran them."""
    t_after = time.perf_counter()
    r0 = ranks[0]
    rep: dict = {"card": card}
    names = [w.__name__ for w in wrappers]
    for label in MP_LEGS:
        leg = r0[label]
        loss_d, param_d = leg["vs_one_device"]
        total = {k: sum(r[label]["launches"].get(k, 0) for r in ranks)
                 for k in names}
        leg["launches_total"] = total
        leg["peak_mem_gb_per_rank"] = [r[label]["peak_mem_gb"]
                                       for r in ranks]
        rep[label] = leg
        by_axis = {a: (round(v["ms_per_step"], 2), v["bytes"] // MP_STEPS)
                   for a, v in leg["collectives_by_axis"].items()}
        print(f"15h {label} {leg['mesh']} {leg['global_batch']}: p50_step_ms="
              f"{leg['p50_step_ms']:.2f} tokens_per_s="
              f"{leg['tokens_per_s']:.1f} collective_ms_per_step="
              f"{leg['collective_ms_per_step']:.2f} by axis (ms, bytes a "
              f"step)={by_axis} host_staged_per_step="
              f"{leg['host_staged_per_step']:.0f} peak_mem_gb="
              f"{[round(g, 2) for g in leg['peak_mem_gb_per_rank']]} "
              f"losses={[round(v, 5) for v in leg['losses']]} vs one device "
              f"max |loss diff|={loss_d:.3g} max |param diff|={param_d:.3g} "
              f"launches={total}", flush=True)
        if not (loss_d <= TOL_MP_LOSS and param_d <= TOL_MP_PARAMS):
            fail(f"15h {label}: off the one-device step by {loss_d} "
                 f"(losses, tol {TOL_MP_LOSS}), {param_d} (params, tol "
                 f"{TOL_MP_PARAMS})")
    pp = rep["pp"]
    zl, zp = pp["zero1_vs_replicated"]
    want, got = pp["ckpt_next_loss"]
    print(f"15h pp zero1: vs replicated max |loss diff|={zl:.3g} max |param "
          f"diff|={zp:.3g}; checkpoint save_s={pp['ckpt_save_s']:.2f}, "
          f"restored into one device next loss {got:.5f} vs mesh "
          f"{want:.5f} (restore + step s="
          f"{pp['ckpt_restore_one_device_s']:.2f})", flush=True)
    if zl > TOL_DP_STAGE or zp > TOL_DP_PARAMS:
        fail(f"15h pp: zero1 off the replicated step by {zl} (losses, tol "
             f"{TOL_DP_STAGE}), {zp} (params, tol {TOL_DP_PARAMS})")
    if abs(got - want) > TOL_MP_LOSS:
        fail(f"15h pp: the ZeRO-1 checkpoint restored at one device steps "
             f"to {got}, the mesh to {want} (tol {TOL_MP_LOSS})")
    rep["ep"] = r0["ep"]
    for label, e in rep["ep"].items():
        print(f"15h ep {label}: vocab={e['vocab']} rows_per_shard="
              f"{e['rows_per_shard']} fit_s={e['fit_s']:.2f} vs one device "
              f"max |diff|={e['vs_one_device']:.3g} collectives="
              f"{ {a: round(v['seconds'], 3) for a, v in e['collectives_by_axis'].items()} }",
              flush=True)
        if not e["vs_one_device"] <= TOL_MP_EP:
            fail(f"15h ep {label}: off the one-device fit by "
                 f"{e['vs_one_device']} (tol {TOL_MP_EP})")
    if run.dryrun:
        proc = run.proc
        if proc is None:
            fail("15h: the LM legs never reported, so the dryrun never ran")
        try:
            out, err = proc.communicate(timeout=DP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        ok = [ln for ln in out.splitlines()
              if ln.startswith("dryrun_multichip OK: ")]
        rep["dryrun"] = {"rc": proc.returncode, "line": ok[:1],
                         "s": time.perf_counter() - run.t_dryrun,
                         "after_the_ranks_s": time.perf_counter() - t_after}
        print(f"15h dryrun --devices 8 ({run.dev}): rc={proc.returncode} "
              f"s={rep['dryrun']['s']:.1f} (beside the ep leg; "
              f"{rep['dryrun']['after_the_ranks_s']:.1f} after it) "
              f"{ok[:1]}", flush=True)
        if proc.returncode != 0 or len(ok) != 1:
            fail(f"15h dryrun: rc {proc.returncode}\n{out[-2000:]}"
                 f"\n{err[-4000:]}")

    # the legs of the kernels line: a tp rank attends over 6 heads of 8 x
    # 512 and scores its 8 x 512 tokens; an sp rank scores 4 x 1024 (its
    # ring is torch ops); a pp rank runs micro-batches of one 2048-row
    # sequence through its stage and scores its 4 x 2048 tokens
    def leg(batch, seq, causal, heads, label, kernels):
        total = rep[label]["launches_total"]
        return {"batch": batch, "seq": seq, "causal": causal,
                "heads": heads,
                "launches": {k: (total[k] if k in kernels else 0)
                             for k in names}}

    attn = ("flash_attention", "fused_attention")
    ln = ("fused_residual_layernorm",)
    xent = ("blocked_cross_entropy",)
    legs = [leg(8, 512, False, 6, "tp", attn + ln + xent),
            leg(4, 1024, True, 6, "sp", attn + ln + xent),
            leg(1, 2048, True, 12, "pp", attn + ln),
            leg(4, 2048, True, 12, "pp", xent)]
    total = {k: sum(lg["launches"][k] for lg in legs) for k in names}
    for k, lbl in (("flash_attention", "tp"), ("fused_attention", "pp"),
                   ("fused_residual_layernorm", "pp"),
                   ("blocked_cross_entropy", "tp")):
        if expect_launches and rep[lbl]["launches_total"][k] <= 0:
            fail(f"15h: {k} was not launched in the {lbl} leg: "
                 f"{rep[lbl]['launches_total']}")
    rep["legs"] = legs
    rep["launches"] = total
    rep["ranks_s"] = ranks_s
    rep["phase_s"] = ranks_s + time.perf_counter() - t_after
    print(f"model parallel: {card} | phase_s={rep['phase_s']:.1f} "
          f"(the ranks {ranks_s:.1f}) launches={total}", flush=True)
    return rep


# ------------------------------------------------------------------ control plane

#: phase 15i (run_control_plane): the Driver at leg A's config over one
#: NCCL rank, CTL_STEPS steps of CTL_BATCH x DP_SEQ, a checkpoint every
#: CTL_EVERY (3, not 2: a save of the 0.88 GB state takes ~2.8 s on the
#: card's host), the first Driver's stop after CTL_HALF steps (the second
#: resumes from it) and the injected step fault of the supervised leg
CTL_BATCH = 16
CTL_STEPS = 6
CTL_EVERY = 3
CTL_HALF = 3
CTL_FAULT_STEP = 4
#: the scaleout word2vec on the card: a seeded topic corpus (tokens,
#: words, topics), sentences a job, three hogwild worker threads
CTL_W2V_TOKENS, CTL_W2V_VOCAB, CTL_W2V_TOPICS = 50_000, 1_000, 10
CTL_W2V_CHUNK = 8
#: the reference test's corpus (tests/test_sharded_embedding.py), for its
#: similarity ordering and the one-worker card-against-CPU run
CTL_W2V_CORPUS = [
    "the cat sat on the mat", "the dog sat on the rug",
    "a cat and a dog played", "the king ruled the land",
    "the queen ruled the kingdom", "a king and a queen reigned",
    "cats chase mice in the barn", "dogs chase cats in the yard"] * 6
# the one-worker iterative-reduce word2vec, card against CPU, every table
# entry: the same float32 steps but for the order of the scatter-adds'
# sums (the CPU tests hold the port against the reference at the same
# 1e-5, measured 1.1e-6)
TOL_CTL_W2V = 1e-5
#: seconds a scaleout process run or CLI call of 15i may take
CTL_TIMEOUT_S = 120


class _ProbedPerformer:
    """A performer of the scaleout workers that also records, in the state
    directory, what its worker process imported (``modules/<pid>.json``):
    any ``jax`` / ``deeplearning4j_tpu`` module and whether CUDA was
    initialised."""

    def __init__(self, inner, tracker, sleep_s=0.0):
        self.inner, self.tracker, self.sleep_s = inner, tracker, sleep_s

    def perform(self, job) -> None:
        if self.sleep_s:
            time.sleep(self.sleep_s)
        self.inner.perform(job)
        import torch

        bad = sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "deeplearning4j_tpu"))
        out = self.tracker.dir / "modules"
        out.mkdir(exist_ok=True)
        (out / f"{os.getpid()}.json").write_text(json.dumps({
            "forbidden": bad, "cuda_initialized": torch.cuda.is_initialized(),
            "main": sys.modules["__main__"].__spec__.name}))

    def update(self, *args) -> None:
        self.inner.update(*args)


def probed_slow_word_count(tracker):
    """The word count with 0.1 s a job: jobs stay in flight while the wave
    grows and shrinks."""
    from deeplearning4j_tpu_torch.parallel import performers

    return _ProbedPerformer(performers.WordCountPerformer(tracker), tracker,
                            sleep_s=0.1)


def probed_svmlight(tracker):
    from deeplearning4j_tpu_torch.parallel import performers

    return _ProbedPerformer(performers.SVMLightTrainPerformer(tracker),
                            tracker)


def _worker_records(state) -> list:
    return [json.loads(p.read_text())
            for p in sorted((Path(state) / "modules").glob("*.json"))]


def _clean_workers(state, n_min, label) -> list:
    recs = _worker_records(state)
    bad = [r for r in recs if r["forbidden"] or r["cuda_initialized"]
           or r["main"] != "deeplearning4j_tpu_torch.parallel.worker_main"]
    if len(recs) < n_min or bad:
        fail(f"15i {label}: worker records {recs}")
    return recs


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ckpt_bytes(directory) -> int:
    """Bytes of the newest checkpoint under ``directory``."""
    newest = max(Path(directory).rglob("params.npz"),
                 key=lambda p: p.stat().st_mtime).parent
    return sum(p.stat().st_size for p in newest.rglob("*") if p.is_file())


def ctl_driver(torch, wrappers, cfg, dev, tmp, label="15i"):
    """15i a: the Driver at ``cfg``'s width over one rank (NCCL on the card,
    gloo on the CPU), joining the group itself (``multihost=True``) through
    the launch contract ``provision`` sets (MASTER_ADDR/MASTER_PORT/
    WORLD_SIZE/RANK), stopping after CTL_HALF steps with ``/status`` and
    ``/metrics`` answered mid-run; a second Driver on the same directory
    resuming over the whole stream; and a supervised Driver under an
    injected step fault.  Each run's losses and params are held bitwise
    to a bare ``DataParallelTrainer.fit`` on the Driver's mesh with the
    same params and batches.  Returns the report and the Driver runs' launches."""
    import urllib.request

    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.observability import METRICS
    from deeplearning4j_tpu_torch.optimize import transforms as TT
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer, Driver
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh
    from deeplearning4j_tpu_torch.resilience import (FaultSpec, RetryPolicy,
                                                     inject_faults)

    def loss_fn(p, x, y, gen=None):
        return ttr.lm_loss_local(p, x, y, cfg)

    def tx():
        return TT.chain(TT.momentum(0.9), TT.sgd_lr(DP_LR))

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "1", "RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    rep: dict = {}
    try:
        params, batches = dp_inputs(torch, ttr, cfg, dev, CTL_STEPS,
                                    batch=CTL_BATCH)
        answers = {}
        d = Driver(loss_fn, tx(), multihost=True,
                   checkpoint_dir=Path(tmp) / "run",
                   checkpoint_every=CTL_EVERY, status_port=0, device=dev)
        rep["backend"] = pmesh.backend()
        if d.mesh.group is None or rep["backend"] != backend:
            fail(f"{label}: the Driver joined {rep['backend']}, not "
                 f"{backend}, or its mesh has no group")
        # the bare trainer on the Driver's mesh (one rank of the group),
        # its params after CTL_HALF steps and after all of them
        bare = DataParallelTrainer(loss_fn, tx(), mesh=d.mesh, device=dev)
        s0, want = bare.fit(bare.init_state(params), batches[:CTL_HALF])
        p_half = bare.final_params(s0)
        s0, more = bare.fit(s0, batches)
        want = want + more
        p0 = bare.final_params(s0)
        del bare, s0
        reset_counts(wrappers)
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        class Asked(list):
            """The batch stream, asking the status server mid-run."""

            def __iter__(self):
                for i, b in enumerate(list.__iter__(self)):
                    if i == CTL_HALF // 2:
                        base = f"http://127.0.0.1:{d.status_server.port}"
                        for path in ("/status", "/metrics"):
                            answers[path] = json.loads(urllib.request.urlopen(
                                base + path, timeout=30).read())
                    yield b

        # the Driver stops after CTL_HALF steps (saved there); a second
        # Driver on the same directory resumes over the whole stream
        METRICS.reset()
        t0 = time.perf_counter()
        state, got = d.run(params, Asked(batches[:CTL_HALF]))
        rep["driver_s"] = time.perf_counter() - t0
        snap = METRICS.snapshot()
        d.close()
        pd = max((a.float() - b.float()).abs().max().item() for a, b in zip(
            _leaves(d.final_params(state)), _leaves(p_half)))
        if got != want[:CTL_HALF] or pd != 0.0:
            fail(f"{label}: Driver losses {got} != DataParallelTrainer.fit "
                 f"{want[:CTL_HALF]}, params off by {pd}")
        if answers.get("/status") != {} or "counters" not in answers.get(
                "/metrics", {}):
            fail(f"{label}: status server mid-run answered {answers}")
        ex = snap["timers"]["train_step.execute"]
        rep.update(
            losses=got, status_mid_run=sorted(answers),
            p50_step_ms=1e3 * ex["p50_s"],
            save_s=snap["timers"]["checkpoint.save"]["p50_s"],
            saves=snap["timers"]["checkpoint.save"]["count"],
            ckpt_bytes=_ckpt_bytes(Path(tmp) / "run"),
            driver_steps=snap["counters"]["driver.steps"])
        rep["tokens_per_s"] = CTL_BATCH * DP_SEQ / (rep["p50_step_ms"] / 1e3)
        del d, state
        METRICS.reset()
        d2 = Driver(loss_fn, tx(), checkpoint_dir=Path(tmp) / "run",
                    device=dev)
        s2, rest = d2.run(params, batches)
        rep["restore_s"] = METRICS.snapshot()["timers"][
            "checkpoint.restore"]["p50_s"]
        pd = max((a.float() - b.float()).abs().max().item() for a, b in zip(
            _leaves(d2.final_params(s2)), _leaves(p0)))
        if s2.step != CTL_STEPS or rest != want[CTL_HALF:] or pd != 0.0:
            fail(f"{label}: resumed Driver at step {s2.step} losses {rest} "
                 f"!= {want[CTL_HALF:]}, params off by {pd}")
        del d2, s2

        # supervised: a transient step fault, retried from the newest save
        METRICS.reset()
        d3 = Driver(loss_fn, tx(), checkpoint_dir=Path(tmp) / "sup",
                    checkpoint_every=CTL_EVERY, device=dev,
                    retry_policy=RetryPolicy(max_attempts=3,
                                             backoff_base_s=0.0))
        with inject_faults(FaultSpec("train.step", at_step=CTL_FAULT_STEP)):
            s3, sup = d3.run(params, batches)
        retries = METRICS.snapshot()["counters"].get("resilience.retries", 0)
        resumed_at = (CTL_FAULT_STEP - 1) // CTL_EVERY * CTL_EVERY
        pd3 = max((a.float() - b.float()).abs().max().item() for a, b in zip(
            _leaves(d3.final_params(s3)), _leaves(p0)))
        if s3.step != CTL_STEPS or sup != want[resumed_at:] or pd3 != 0.0 \
                or retries < 1:
            fail(f"{label}: supervised Driver at step {s3.step}, losses "
                 f"{sup} vs {want[resumed_at:]}, params off by {pd3}, "
                 f"retries {retries}")
        rep["supervised"] = {"losses": sup, "retries": retries,
                             "resumed_at": resumed_at}
        rep["peak_mem_gb"] = _peak_gb(torch, dev)
        launches = _counts(wrappers)
        del d3, s3, params, batches, p0
    finally:
        pmesh.shutdown_multihost()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rep, launches


def _leaves(tree) -> list:
    from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves

    return tree_leaves(tree)


def _w2v_tables(np, corpus, dev, negative, layer_size=100, window=5):
    """A vocab-initialised Word2Vec on ``dev``, its tables, the corpus as
    index arrays and the Huffman arrays."""
    from deeplearning4j_tpu_torch.text import scaleout_embeddings as tse
    from deeplearning4j_tpu_torch.text.word2vec import Word2Vec

    w2v = Word2Vec(corpus, layer_size=layer_size, window=window,
                   negative=negative, use_hierarchic_softmax=negative == 0,
                   seed=3, device=dev)
    w2v.build_vocab()
    w2v.reset_weights()
    fac = w2v.tokenizer_factory
    sents = []
    for s in corpus:
        idx = np.array([i for i in (w2v.vocab.index_of(t) for t in
                                    fac.create(s).get_tokens()) if i >= 0],
                       np.int32)
        if idx.size >= 2:
            sents.append(idx)
    return w2v, tse.EmbeddingTables.from_model(w2v), sents, \
        w2v.huffman.code_arrays()


def _w2v_run(np, tables, sents, huffman, negative, dev, n_workers, router,
             chunk, alpha, window, seed=5):
    """The scaleout word2vec: ``n_workers`` threads of Word2VecPerformer on
    ``dev`` under ``router``, RowDeltaAggregator into ``tables``.  Returns
    (seconds, words trained)."""
    from deeplearning4j_tpu_torch.parallel import scaleout as tso
    from deeplearning4j_tpu_torch.text import scaleout_embeddings as tse

    codes, points, lengths = huffman
    hs = negative == 0
    tracker = tso.StateTracker()
    it = tse.Word2VecJobIterator(sents, tables, window=window, chunk=chunk,
                                 negative=negative, alpha=alpha,
                                 tracker=tracker, seed=seed)
    runner = tso.DistributedRunner(
        it, lambda tr: tse.Word2VecPerformer(
            tr, window=window, negative=negative,
            codes=codes.astype(np.float32) if hs else None,
            points=points if hs else None, lengths=lengths if hs else None,
            device=dev),
        n_workers=n_workers, router_cls=router, tracker=tracker)
    runner.router.aggregator_factory = lambda: tse.RowDeltaAggregator(tables)
    t0 = time.perf_counter()
    runner.run(max_wall_s=CTL_TIMEOUT_S)
    return time.perf_counter() - t0, tracker.count(tse.WORDS_KEY)


def ctl_word2vec(torch, dev, label="15i"):
    """15i b: the scaleout word2vec with its steps on ``dev``: three hogwild
    worker threads, HS then NS, on the reference test's corpus (its
    similarity ordering) and on a seeded ~50k-token topic corpus
    (within-topic similarity above cross-topic); one iterative-reduce
    worker on ``dev`` against the same run on the CPU."""
    import numpy as np

    from deeplearning4j_tpu_torch.parallel import scaleout as tso

    out = {}
    topic, _, topic_words = topic_corpus(
        np, n_tokens=CTL_W2V_TOKENS, vocab=CTL_W2V_VOCAB,
        topics=CTL_W2V_TOPICS)
    # negatives: the reference test's 3 on its corpus, word2vec's usual 5
    # on the topic corpus
    for mode, negative, neg_topic in (("hs", 0, 0), ("ns", 3, 5)):
        rep = {}
        w2v, tables, sents, huff = _w2v_tables(np, CTL_W2V_CORPUS, dev,
                                               negative, layer_size=24,
                                               window=3)
        s, words = _w2v_run(np, tables, sents * 12, huff, negative, dev, 3,
                            tso.HogWildWorkRouter, 6, 0.05, 3)
        w2v.syn0 = torch.as_tensor(tables.syn0, device=dev)
        order = (w2v.similarity("king", "queen"),
                 w2v.similarity("king", "mat"), w2v.similarity("cat", "dog"),
                 w2v.similarity("cat", "kingdom"))
        if not (order[0] > order[1] and order[2] > order[3]):
            fail(f"{label} word2vec {mode}: similarity ordering {order}")
        rep["reference_corpus"] = {"fit_s": s, "words": words,
                                   "similarities": order}
        w2v, tables, sents, huff = _w2v_tables(np, topic, dev, neg_topic)
        s, words = _w2v_run(np, tables, sents, huff, neg_topic, dev, 3,
                            tso.HogWildWorkRouter, CTL_W2V_CHUNK, 0.025, 5)
        if not np.isfinite(tables.syn0).all():
            fail(f"{label} word2vec {mode}: non-finite table")
        w2v.syn0 = torch.as_tensor(tables.syn0, device=dev)
        within, across = topic_similarity(w2v, topic_words)
        if not within > across:
            fail(f"{label} word2vec {mode}: within-topic {within} <= "
                 f"cross-topic {across}")
        rep["topic_corpus"] = {"fit_s": s, "words": words,
                               "words_per_s": words / s,
                               "within": within, "across": across}
        # one iterative-reduce worker: the card against the CPU
        runs = []
        for where in (dev, "cpu"):
            _, tables, sents, huff = _w2v_tables(
                np, CTL_W2V_CORPUS, "cpu", negative, layer_size=24, window=3)
            _w2v_run(np, tables, sents * 4, huff, negative, where, 1,
                     tso.IterativeReduceWorkRouter, 6, 0.05, 3)
            runs.append(tables)
        err = max(float(np.abs(getattr(runs[0], n) - getattr(runs[1], n))
                        .max()) for n in ("syn0", "syn1", "syn1neg")
                  if getattr(runs[0], n) is not None)
        if err > TOL_CTL_W2V:
            fail(f"{label} word2vec {mode}: one worker on {dev} vs CPU "
                 f"max |diff| {err}")
        rep["one_worker_vs_cpu"] = err
        out[mode] = rep
        print(f"{label} scaleout word2vec {mode}: 3 hogwild workers, "
              f"reference corpus fit_s={rep['reference_corpus']['fit_s']:.2f}"
              f" king~queen {order[0]:.3f} > king~mat {order[1]:.3f}, "
              f"cat~dog {order[2]:.3f} > cat~kingdom {order[3]:.3f}; topic "
              f"corpus ({CTL_W2V_TOKENS} tokens) fit_s={s:.2f} words_per_s="
              f"{words / s:.0f} within {within:.3f} > across {across:.3f}; "
              f"one worker vs CPU max |diff|={err:.3g}", flush=True)
    return out


def _svmlight_superstep_jobs(np, tmp):
    """The reference test's svmlight superstep (tests/test_multiprocess.py):
    a seeded two-class file, two byte-range splits x 6 epochs of jobs."""
    from deeplearning4j_tpu_torch.datasets.svmlight import save_svmlight

    rng = np.random.default_rng(3)
    n, d, c = 200, 6, 2
    labels = rng.integers(0, c, n)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    feats += 2.5 * labels[:, None] * np.eye(d, dtype=np.float32)[0]
    feats[:, -1] = 1.0
    path = Path(tmp) / "corpus.svmlight"
    save_svmlight(path, feats, labels)
    size = path.stat().st_size
    splits = [(0, size // 2), (size // 2, size)]
    return path, [f"{path}::{s}::{e}::{d}::{c}" for _ in range(6)
                  for (s, e) in splits], d, c


def _in_thread(fn, out, key):
    """``fn()`` on a daemon thread, its value under ``out[key]``."""
    import threading

    th = threading.Thread(target=lambda: out.update({key: fn()}),
                          daemon=True)
    th.start()
    return th


def ctl_processes(tmp, root, label="15i"):
    """15i c/d: the OS-process legs at once (each worker's start-up, ~8 s
    on the card's host, and each CLI process's ``import torch`` overlap):
    ``ProcessDistributedRunner`` with two host workers on the slow word
    count (its count exact) while ``wave_actuators`` grows the wave by a
    third process and then retires an idle worker, and on the svmlight
    superstep (its averaged model equal to the thread runner's); a
    ``scaleout`` CLI master with one worker, stopped mid-run by
    ``scaleout -t kill``; ``provision`` as a dry run with a stub ``gcloud``
    that must not run.  The ``scaleout.*`` counters are printed (an
    eviction or a requeue would reshape the superstep's waves)."""
    from collections import Counter

    import numpy as np

    from deeplearning4j_tpu_torch.control.autoscaler import wave_actuators
    from deeplearning4j_tpu_torch.datasets.svmlight import load_svmlight
    from deeplearning4j_tpu_torch.observability import METRICS
    from deeplearning4j_tpu_torch.parallel import performers as tperf
    from deeplearning4j_tpu_torch.parallel import scaleout as tso
    from deeplearning4j_tpu_torch.parallel.procrunner import (
        ProcessDistributedRunner)
    from deeplearning4j_tpu_torch.parallel.procstate import FileStateTracker

    rep, out = {}, {}
    env = {"OMP_NUM_THREADS": "1"}
    cli_env = {**os.environ, **env}
    METRICS.reset()
    t0 = time.perf_counter()

    def cli(*argv, **kw):
        return subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", *argv],
            cwd=str(root), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, **{"env": cli_env, **kw})

    # ---- the CLI master (400 slow jobs: still running when the kill
    # comes) and the provision dry run, with a gcloud that must not run
    jobs_file = Path(tmp) / "jobs.txt"
    jobs_file.write_text("\n".join(f"a b{i % 5} c" for i in range(400)))
    cli_state = Path(tmp) / "cli"
    bindir = Path(tmp) / "bin"
    bindir.mkdir()
    log = Path(tmp) / "gcloud.log"
    (bindir / "gcloud").write_text(f'#!/bin/sh\necho "$@" >> {log}\n')
    (bindir / "gcloud").chmod(0o755)
    procs = [cli("scaleout", "--state-dir", str(cli_state), "--jobs",
                 str(jobs_file), "--workers", "1", "--performer",
                 "chip_smoke:probed_slow_word_count"),
             cli("provision", "--repo-url", "https://example.com/r.git",
                 "--dry-run-apply", env={**cli_env, "PATH": f"{bindir}:"
                                          f"{os.environ.get('PATH', '')}"})]
    try:
        # ---- the svmlight superstep: two workers, two splits a wave
        path, jobs, d, c = _svmlight_superstep_jobs(np, tmp)
        svm_state = Path(tmp) / "svm"
        th_svm = _in_thread(lambda: (np.asarray(ProcessDistributedRunner(
            tso.CollectionJobIterator(jobs), "chip_smoke:probed_svmlight",
            state_dir=svm_state, n_workers=2, worker_env=env).run(
                max_wall_s=CTL_TIMEOUT_S)),
            time.perf_counter() - t0), out, "svm")
        # ---- the word count, with the wave grown and shrunk under it
        lines = [f"w{i % 7} w{i % 3} x" for i in range(30)]
        state = Path(tmp) / "wc"
        runner = ProcessDistributedRunner(
            tso.CollectionJobIterator(lines),
            "chip_smoke:probed_slow_word_count", state_dir=state,
            n_workers=2, router_cls=tperf.WordCountRouter, worker_env=env)
        up, down, size = wave_actuators(runner)
        th = _in_thread(lambda: runner.run(max_wall_s=CTL_TIMEOUT_S), out,
                        "wc")
        deadline = time.time() + CTL_TIMEOUT_S
        while not runner.tracker.current_jobs() and time.time() < deadline:
            time.sleep(0.02)
        boot_s = time.perf_counter() - t0
        up()
        grown = size()
        new = runner._spawned_wids[-1]
        while not (state / "boot" / new).exists() \
                and time.time() < deadline:
            time.sleep(0.05)
        retired, tries = None, 0
        while retired is None and time.time() < deadline:
            try:
                down()
                retired = True
            except RuntimeError:      # every worker mid-job: next window
                tries += 1
                time.sleep(0.05)
        # kill the CLI master once a wave of it has been aggregated
        while time.time() < deadline and not (
                (cli_state / "current").exists()
                and FileStateTracker(cli_state).get_current()):
            time.sleep(0.1)
        killed = cli("scaleout", "-t", "kill", "--state-dir", str(cli_state))
        procs.append(killed)
        th.join(timeout=CTL_TIMEOUT_S)
        wc_s = time.perf_counter() - t0
        th_svm.join(timeout=CTL_TIMEOUT_S)
        outs = [pr.communicate(timeout=CTL_TIMEOUT_S) for pr in procs]
        stop_s = time.perf_counter() - t0
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    counters = {k: v for k, v in METRICS.snapshot()["counters"].items()
                if k.startswith("scaleout.")}
    want = Counter(" ".join(lines).split())
    if th.is_alive() or out.get("wc") != want or grown != 3 \
            or not retired or size() != 2 \
            or new not in runner.tracker.workers():
        fail(f"{label} wave: count {out.get('wc')} vs {want}, sizes "
             f"{grown} then {size()}, retired {retired}, workers "
             f"{runner.tracker.workers()}, {counters}")
    recs = _clean_workers(state, 3, "word count")
    rep["word_count"] = {"s": wc_s, "boot_s": boot_s, "jobs": len(lines),
                         "workers_seen": len(recs),
                         "wave": [2, grown, size()],
                         "retire_windows_refused": tries}
    if "svm" not in out:
        fail(f"{label} svmlight superstep did not finish: {counters}")
    w, svm_s = out["svm"]
    ref = tso.DistributedRunner(
        tso.CollectionJobIterator(jobs), tperf.SVMLightTrainPerformer,
        n_workers=2).run(max_wall_s=CTL_TIMEOUT_S)
    x, y = load_svmlight(path, d, c)
    acc = float((np.argmax(x @ w.reshape(d, c), -1) == y.argmax(-1)).mean())
    diff = float(np.abs(w - ref).max())
    if diff > 1e-12 or acc <= 0.9:
        fail(f"{label} svmlight superstep: |processes - threads| {diff}, "
             f"accuracy {acc}, {counters}")
    _clean_workers(svm_state, 2, "svmlight")
    rep["svmlight"] = {"s": svm_s, "accuracy": acc, "vs_threads": diff}
    (mout, merr), (pout, perr), (_, kerr) = outs
    master, prov = procs[0], procs[1]
    counted = (json.loads(mout.strip().splitlines()[-1]) if mout.strip()
               else None) or {}
    if killed.returncode != 0 or master.returncode != 0 \
            or not FileStateTracker(cli_state).is_done() \
            or not 0 < counted.get("a", 0) < 400:
        fail(f"{label} CLI: kill rc {killed.returncode} ({kerr[-300:]}), "
             f"master rc {master.returncode} ({merr[-500:]}), counted "
             f"{counted.get('a')} of 400")
    _clean_workers(cli_state, 1, "CLI master")
    recs = [json.loads(ln) for ln in pout.splitlines() if ln.startswith("{")]
    if prov.returncode != 0 or log.exists() or [r["step"] for r in recs] != [
            "create", "bootstrap", "resolve_coordinator", "launch"] \
            or any(r["rc"] is not None for r in recs):
        fail(f"{label} provision dry run: rc {prov.returncode}, executed "
             f"{log.exists()}, records {recs} {perr[-300:]}")
    rep["cli"] = {"master_counted_a": counted.get("a"), "of": 400,
                  "provision_steps": [r["step"] for r in recs]}
    rep["scaleout_counters"] = counters
    rep["s"] = stop_s
    print(f"{label} processes (the legs at once, s={stop_s:.2f}): word "
          f"count over 2 workers, wave 2->{grown}->{size()} (retire refused "
          f"{tries} windows while every worker was mid-job), exact, s="
          f"{wc_s:.2f} (boot {boot_s:.2f}); svmlight superstep s="
          f"{svm_s:.2f} accuracy={acc:.3f} |processes - threads|="
          f"{diff:.3g}; CLI master killed after {counted.get('a')}/400 "
          f"jobs; provision dry run {len(recs)} steps, nothing executed; "
          f"no worker imported jax or deeplearning4j_tpu or initialised "
          f"CUDA; {counters}", flush=True)
    return rep


def run_control_plane(torch, wrappers, card, root=ROOT, dev="cuda",
                      cfg_kw=None, expect_launches=True):
    """Phase 15i: the host control plane.  a. the ``Driver`` at leg A's
    width over one rank (``ctl_driver``); b. the scaleout
    word2vec on ``dev`` (``ctl_word2vec``); c./d. the process runner, the
    wave and the CLI (``ctl_processes``).  The Driver runs' launches of
    #1/#3/#4 are counted from 0 and returned as a leg of the kernels
    line."""
    from deeplearning4j_tpu_torch.models import transformer as ttr

    import shutil

    t_phase = time.perf_counter()
    cfg = dp_config(torch, ttr, cfg_kw)
    tmp = tempfile.mkdtemp(prefix="dl4j_ctl_")
    try:
        rep, launches = ctl_driver(torch, wrappers, cfg, dev, tmp)
        rep["driver_part_s"] = time.perf_counter() - t_phase
        names = ("flash_attention", "fused_residual_layernorm",
                 "blocked_cross_entropy")
        if expect_launches and not all(launches[k] > 0 for k in names):
            fail(f"15i: the Driver did not run through its kernels: "
                 f"{launches}")
        print(f"15i Driver ({rep['backend']}, one rank, leg A's config, "
              f"{CTL_BATCH} x {DP_SEQ}, {CTL_STEPS} steps): losses "
              f"bitwise DataParallelTrainer.fit's, /status and /metrics "
              f"answered mid-run, resumed at step {CTL_HALF} and supervised"
              f" through a step-{CTL_FAULT_STEP} fault to the same losses; "
              f"p50_step_ms={rep['p50_step_ms']:.2f} tokens_per_s="
              f"{rep['tokens_per_s']:.1f} save_s={rep['save_s']:.3f} "
              f"restore_s={rep['restore_s']:.3f} ckpt_bytes="
              f"{rep['ckpt_bytes']} peak_mem_gb={rep['peak_mem_gb']:.2f} "
              f"launches={launches}", flush=True)
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rep["word2vec"] = ctl_word2vec(torch, dev)
        rep["word2vec_s"] = time.perf_counter() - t0
        rep["processes"] = ctl_processes(tmp, root)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rep["launches"] = launches
    rep["legs"] = [{"batch": CTL_BATCH, "seq": DP_SEQ, "causal": cfg.causal,
                    "launches": launches}]
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"control plane: {card} | phase_s={rep['phase_s']:.1f} (Driver "
          f"{rep['driver_part_s']:.1f}, word2vec {rep['word2vec_s']:.1f}, "
          f"processes {rep['processes']['s']:.1f}) launches={launches}",
          flush=True)
    return rep


#: phase 15j (run_guards): the analysis tier's runtime guards.  The cost
#: pairs run engine A's serving config on GUARD_PROMPTS prompts of
#: GUARD_PROMPT_LEN tokens (NEW_TOKENS new), and fit at 15i's Driver
#: config (CTL_BATCH x DP_SEQ) for GUARD_FIT_STEPS steps, each mode in
#: turn; two engines then serve GUARD_CONCURRENT requests each at once
GUARD_PROMPTS, GUARD_PROMPT_LEN, GUARD_FIT_STEPS = 8, 8, 5
GUARD_CONCURRENT, GUARD_CONCURRENT_NEW = 4, 8
#: the modes a cost pair runs, in order: the guard off and on, twice;
#: and the guard's own enter/exit, timed alone over GUARD_ENTRIES entries
GUARD_MODES = ("off", "on", "on", "off")
GUARD_ENTRIES = 2000


@contextlib.contextmanager
def transfer_guard_as(rt, mode):
    """``DL4J_TPU_TRANSFER_GUARD`` for one run: "off" opts out, "on" is
    the default."""
    saved = os.environ.get(rt.ENV_FLAG)
    if mode == "off":
        os.environ[rt.ENV_FLAG] = "0"
    else:
        os.environ.pop(rt.ENV_FLAG, None)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(rt.ENV_FLAG, None)
        else:
            os.environ[rt.ENV_FLAG] = saved


def guard_refusals(torch, rt, dev):
    """On this thread inside ``hot_loop_guard()``: the syncs raise at
    their call site, an async upload from pinned memory passes,
    ``allow_transfers()`` re-allows every sync, ``log`` mode counts them
    without raising; meanwhile a second thread reads unguarded and
    passes.  Returns the report."""
    import threading

    x = torch.arange(4096, device=dev, dtype=torch.float32)
    host = torch.arange(4096, dtype=torch.float32)          # pageable
    on_card = torch.device(dev).type == "cuda"
    pinned = host.pin_memory() if on_card else host
    syncs = {"item": lambda: x.sum().item(), "float": lambda: float(x[7]),
             "bool": lambda: bool((x > 5).any()),
             "nonzero": lambda: x.nonzero(), "cpu": lambda: x.cpu(),
             "tolist": lambda: x[:4].tolist(),
             "pageable upload": lambda: host.to(dev)}
    # a CPU tensor's copies wait for nothing (the CPU rehearsal)
    expect = set(syncs) if on_card else {"item", "float", "bool", "nonzero"}
    rt.reset_counts()
    refused = set()
    with transfer_guard_as(rt, "on"), rt.hot_loop_guard() as mode:
        for name, fn in syncs.items():
            try:
                fn()
            except rt.HostSyncError:
                refused.add(name)
        up = pinned.to(dev, non_blocking=True)
        with rt.allow_transfers():
            for fn in syncs.values():
                fn()
            up_ok = torch.equal(up.cpu(), host)
    if mode != "disallow" or refused != expect or not up_ok:
        fail(f"15j: the guard ({mode}) refused {sorted(refused)}, not "
             f"{sorted(expect)}, or the pinned upload went wrong ({up_ok})")
    # log mode: counted, not raised
    saved = os.environ.get(rt.ENV_FLAG)
    os.environ[rt.ENV_FLAG] = "log"
    rt.reset_counts()
    try:
        with rt.hot_loop_guard():
            for fn in syncs.values():
                fn()
    finally:
        if saved is None:
            os.environ.pop(rt.ENV_FLAG, None)
        else:
            os.environ[rt.ENV_FLAG] = saved
    logged = rt.counts()
    if logged["logged"] != len(expect) or logged["refused"]:
        fail(f"15j: log mode counted {logged}, not {len(expect)} syncs")
    # scope: while this thread is inside the guard, another thread makes
    # the same reads unguarded (they pass); then this thread's is refused
    inside, read, out = threading.Event(), threading.Event(), {}

    def plain():
        inside.wait(30)
        try:
            out["plain"] = [fn() is not None for fn in syncs.values()]
        except Exception as e:      # reported below, a failure
            out["plain"] = repr(e)
        read.set()

    th = threading.Thread(target=plain, daemon=True)
    th.start()
    rt.reset_counts()
    with transfer_guard_as(rt, "on"), rt.hot_loop_guard():
        inside.set()
        read.wait(60)
        try:
            x.sum().item()
            out["guarded"] = "passed"
        except rt.HostSyncError:
            out["guarded"] = "refused"
    th.join(60)
    if out.get("plain") != [True] * len(syncs) \
            or out.get("guarded") != "refused" \
            or rt.counts()["refused"] != 1:
        fail(f"15j: the guard is not scoped to its thread: {out}, "
             f"{rt.counts()}")
    return {"refused": sorted(refused), "pinned_upload": "passed",
            "allow_transfers": "re-allowed all", "log_mode": logged,
            "second_thread": "passed", "guarded_thread": out["guarded"]}


def guard_costs(torch, eng, tmodel, params, scfg, rng, dev, cfg_kw=None,
                modes=GUARD_MODES, guard_as=transfer_guard_as):
    """The transfer guard's cost, each of ``modes`` in turn (``guard_as(rt,
    mode)`` sets one up): engine A's decode step p50 on GUARD_PROMPTS
    prompts, ``fit``'s step p50 at 15i's Driver config, the tokens and
    losses equal in every mode and nothing refused; and the guard's own
    enter and exit in each mode but "off".  Returns the report and
    ``(trainer, state, batches)`` of the fit runs."""
    import dataclasses

    from deeplearning4j_tpu_torch.analysis import runtime as rt
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.observability import METRICS
    from deeplearning4j_tpu_torch.optimize import transforms as TT
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer

    # ---- the decode step: one engine, each mode in turn
    prompts = [rng.integers(0, tmodel.cfg.vocab_size,
                            GUARD_PROMPT_LEN).tolist()
               for _ in range(GUARD_PROMPTS)]
    engine = eng.InferenceEngine(tmodel, params, cfg=scfg, device=dev).start()
    decode, served = {m: [] for m in modes}, None
    try:
        for mode in modes:
            with guard_as(rt, mode):
                METRICS.reset()
                rt.reset_counts()
                hs = [engine.submit(p, NEW_TOKENS) for p in prompts]
                toks = [h.result(timeout=600).tokens for h in hs]
                snap = METRICS.snapshot()["timers"]
                c = rt.counts()
            if served is None:
                served = toks
            if toks != served or c["refused"]:
                fail(f"15j: decode under {mode}: tokens differ or {c}")
            decode[mode].append(snap["serving.decode_step"]["p50_s"] * 1e3)
    finally:
        engine.stop()
    del engine

    # ---- fit's step: 15i's Driver config, each mode in turn from one state
    cfg = dp_config(torch, ttr, cfg_kw)
    fparams, batches = dp_inputs(torch, ttr, cfg, dev, GUARD_FIT_STEPS,
                                 batch=CTL_BATCH)
    trainer = DataParallelTrainer(
        lambda p, x, y, gen=None: ttr.lm_loss_local(p, x, y, cfg),
        TT.chain(TT.momentum(0.9), TT.sgd_lr(DP_LR)), device=dev)
    state0 = trainer.init_state(fparams)
    with guard_as(rt, "off"):     # the first bucket's cost count, warm-up
        trainer.fit(dataclasses.replace(state0), batches[:1])
    fit_ms, losses = {m: [] for m in modes}, None

    class Timed(list):
        """The batch stream, stamping each pull on the host clock."""

        def __iter__(self):
            for b in list.__iter__(self):
                self.stamps.append(time.perf_counter())
                yield b

    for mode in modes:
        stream = Timed(batches)
        stream.stamps = []
        with guard_as(rt, mode):
            rt.reset_counts()
            _, got = trainer.fit(dataclasses.replace(state0), stream,
                                 async_dispatch=False)
            c = rt.counts()
        if losses is None:
            losses = got
        if got != losses or c["refused"] or (mode != "off"
                                             and c["guarded"] != 1):
            fail(f"15j: fit under {mode}: losses {got} vs {losses}, {c}")
        gaps = sorted(b - a for a, b in zip(stream.stamps,
                                            stream.stamps[1:]))
        fit_ms[mode].append(gaps[len(gaps) // 2] * 1e3)

    def pair(d):
        return {m: round(sum(v) / len(v), 5) for m, v in d.items()}

    # the guard's own cost, a decode segment's enter and exit (no sync)
    entry_us = {}
    for mode in dict.fromkeys(m for m in modes if m != "off"):
        with guard_as(rt, mode):
            t0 = time.perf_counter()
            for _ in range(GUARD_ENTRIES):
                with rt.hot_loop_guard():
                    pass
            entry_us[mode] = round(
                (time.perf_counter() - t0) / GUARD_ENTRIES * 1e6, 3)
    rep = {"decode_step_p50_ms": pair(decode), "fit_step_p50_ms": pair(fit_ms),
           "decode_step_runs_ms": decode, "fit_step_runs_ms": fit_ms,
           "guard_entry_us": entry_us}
    return rep, (trainer, state0, batches)


def run_guards(torch, eng, tmodel, params, wrappers, card, dev="cuda",
               cfg_kw=None):
    """Phase 15j: the analysis tier's runtime guards at the flagship's
    width — refusal and scope (``guard_refusals``); two engines (engine
    A's config) serving GUARD_CONCURRENT requests each from their own
    threads at once under the guard, tokens equal to their unguarded
    runs and no refusal; the guard's cost on engine A's decode step and
    on ``fit``'s step at 15i's Driver config (``guard_costs``); a planted
    ``resharded-input`` at ``train.sync_step``."""
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch.analysis import runtime as rt
    from deeplearning4j_tpu_torch.analysis.shardguard import SHARDGUARD
    from deeplearning4j_tpu_torch.observability import METRICS
    from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves, tree_map

    t_phase = time.perf_counter()
    rep = {"card": card}
    rep["refusals"] = guard_refusals(torch, rt, dev)
    mcfg = tmodel.cfg
    rng = np.random.default_rng(17)
    scfg = eng.ServingConfig(slots=8, paged=True, page_size=16,
                             int8_decode=True, paged_attention_impl="pallas")

    # ---- two engines at once, guarded, against their unguarded runs
    sets = [[rng.integers(0, mcfg.vocab_size, GUARD_PROMPT_LEN).tolist()
             for _ in range(GUARD_CONCURRENT)] for _ in range(2)]
    engines = [eng.InferenceEngine(tmodel, params, cfg=scfg,
                                   device=dev).start() for _ in range(2)]
    try:
        with transfer_guard_as(rt, "off"):
            want = [[e.generate(p, GUARD_CONCURRENT_NEW, timeout=600).tokens
                     for p in ps] for e, ps in zip(engines, sets)]
        rt.reset_counts()
        got = [None, None]

        def serve(i):
            hs = [engines[i].submit(p, GUARD_CONCURRENT_NEW)
                  for p in sets[i]]
            got[i] = [h.result(timeout=600).tokens for h in hs]

        with transfer_guard_as(rt, "on"):
            ths = [threading.Thread(target=serve, args=(i,), daemon=True)
                   for i in range(2)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(900)
    finally:
        for e in engines:
            e.stop()
    both = rt.counts()
    if got != want or both["refused"] or both["guarded"] < 2:
        fail(f"15j: two guarded engines served {got} against {want}, "
             f"counts {both}")
    rep["two_engines"] = {"requests_each": GUARD_CONCURRENT,
                          "guarded_segments": both["guarded"],
                          "refused": both["refused"], "tokens_equal": True}
    del engines

    # ---- the guard's cost on the decode step and on fit's step
    costs, (trainer, state0, batches) = guard_costs(
        torch, eng, tmodel, params, scfg, rng, dev, cfg_kw)
    rep.update(costs)
    print(f"guards 15j: {card} | refused {rep['refusals']['refused']}, a "
          f"pinned upload passed, allow_transfers re-allowed, log mode "
          f"counted {rep['refusals']['log_mode']['logged']}, a second "
          f"thread read unguarded meanwhile; two engines x "
          f"{GUARD_CONCURRENT} requests at once: {both['guarded']} guarded "
          f"segments, {both['refused']} refusals, tokens equal | "
          f"decode_step_p50_ms {rep['decode_step_p50_ms']} "
          f"fit_step_p50_ms {rep['fit_step_p50_ms']} (off / on; means of "
          f"the runs {rep['decode_step_runs_ms']} / "
          f"{rep['fit_step_runs_ms']}) guard enter+exit us "
          f"{rep['guard_entry_us']}", flush=True)

    # ---- shardguard: one parameter placed on the host, at the sync step
    SHARDGUARD.reset()
    SHARDGUARD.enable()
    try:
        step = trainer._step_for(CTL_BATCH)
        target = next(t for t in tree_leaves(state0.params) if t.dim() == 2)
        # the host off the card (the meta device in a CPU rehearsal)
        wrong = "cpu" if torch.device(dev).type == "cuda" else "meta"
        bad = tree_map(lambda t: t.to(wrong) if t is target else t,
                       state0.params)
        x, y = batches[0]
        err = None
        try:
            step(bad, state0.tstate, x, y, torch.Generator(device=dev),
                 0, CTL_BATCH)
        except RuntimeError as e:     # the step cannot run on it: expected
            err = type(e).__name__
        vs = SHARDGUARD.violations()
        SHARDGUARD.emit_metrics()
        gauge = METRICS.snapshot()["gauges"].get(
            "shardguard.violations.resharded_input")
    finally:
        SHARDGUARD.disable()
        SHARDGUARD.reset()
    if [(v.kind, v.site) for v in vs] != [("resharded-input",
                                          "train.sync_step")] or gauge != 1:
        fail(f"15j: the planted placement gave {vs}, gauge {gauge}")
    rep["shardguard_planted"] = {"violations": [str(v) for v in vs],
                                 "gauge": gauge, "step_error": err}
    del trainer, state0, batches
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"guards 15j: shardguard planted a host-placed parameter: "
          f"{vs[0]} (gauge {gauge}, the step then raised {err}) | "
          f"phase_s={rep['phase_s']:.1f}", flush=True)
    return rep


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
    from deeplearning4j_tpu_torch.analysis.shardguard import SHARDGUARD
    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.ops.cuda import attention as tat
    from deeplearning4j_tpu_torch.ops.cuda import build, kv_quant, registry
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
    # every kernel module imports: a missing candidate would leave an
    # engine without its kernel
    missing = registry.import_errors()
    if missing:
        fail(f"kernel modules failed to import: {missing}")
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
    SHARDGUARD.reset()                 # engine A's dispatches, checked
    SHARDGUARD.enable()
    engine_a, rep_a = run_engine(eng, tmodel, params, cfg_a, prompts_a,
                                 wrappers, "engine A")
    SHARDGUARD.disable()
    rep_a["shardguard_violations"] = len(SHARDGUARD.violations())
    if rep_a["shardguard_violations"]:
        fail(f"engine A: {SHARDGUARD.report()}")
    la = rep_a["launches"]
    if la["int8_matmul"] <= 0 or la["paged_attention"] <= 0:
        fail(f"engine A did not run through its kernels: {la}")
    tf_a = kernels_vs_plain(torch, ttr, tmm, tpa, kv_quant, mcfg, params,
                            None, "engine A")
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
                            "int8", "engine B")
    rep_b["teacher_forced"] = tf_b
    print(engine_line("engine B", rep_b) + f" teacher_forced={tf_b}",
          flush=True)
    del engine_b

    # ---- 5a. engine F: B's config on fp8 pages, on A's first FS_PROMPTS
    # prompts (so the disaggregated fp8 leg below has a unified engine to
    # equal; not all 16: the script's time limit)
    cfg_f = eng.ServingConfig(slots=8, paged=True, page_size=16,
                              int8_decode=True, kv_quant="fp8",
                              paged_attention_impl="pallas_int8")
    engine_f, rep_f = run_engine(eng, tmodel, params, cfg_f,
                                 prompts_a[:FS_PROMPTS],
                                 wrappers, "engine F")
    engine_f.stop()
    del engine_f
    lf = rep_f["launches"]
    if lf["int8_matmul"] <= 0 or lf["paged_attention_int8"] <= 0:
        fail(f"engine F did not run through its kernels: {lf}")
    tf_f = kernels_vs_plain(torch, ttr, tmm, tpa, kv_quant, mcfg, params,
                            "fp8", "engine F")
    rep_f["teacher_forced"] = tf_f
    print(engine_line("engine F", rep_f) + f" teacher_forced={tf_f}",
          flush=True)

    # ---- 5a'. the disaggregated tier: one prefill-role and one
    # decode-role engine behind DisaggScheduler, A's first DISAGG_PROMPTS
    # prompts (the script's time limit; a request's tokens do not depend
    # on the rest of the batch), on float pages (held to engine A's
    # tokens) and on fp8 pages (engine F's)
    disagg = {label: run_disagg(eng, serving, tmodel, params,
                                prompts_a[:DISAGG_PROMPTS],
                                want["served"][:DISAGG_PROMPTS], label,
                                extra, wrappers, rng)
              for label, extra, want in (
                  ("float", dict(paged_attention_impl="pallas"), rep_a),
                  ("fp8", dict(kv_quant="fp8",
                               paged_attention_impl="pallas_int8"), rep_f))}

    # ---- 5b. the speculative engine S: engine A's config and its first
    # FS_PROMPTS prompts (not all 16: the script's time limit), a random
    # one-layer draft proposing 3 tokens a verify window
    draft_model, draft_params = zoo.draft_lm(mcfg, device="cuda")
    cfg_s = eng.ServingConfig(slots=8, paged=True, page_size=16,
                              int8_decode=True, paged_attention_impl="pallas",
                              speculative=True, spec_k=3)
    engine_s, rep_s = run_engine(eng, tmodel, params, cfg_s,
                                 prompts_a[:FS_PROMPTS],
                                 wrappers, "engine S",
                                 draft_model=draft_model,
                                 draft_params=draft_params)
    engine_s.stop()
    del engine_s, draft_params
    if rep_s["launches"]["int8_matmul"] <= 0:
        fail(f"engine S did not run through its kernels: {rep_s['launches']}")
    rep_s["agreement_with_a"] = token_agreement(rep_s["served"],
                                                rep_a["served"][:FS_PROMPTS])
    rep_s["teacher_forced"] = window_vs_steps(torch, ttr, tmm, tpa, mcfg,
                                              params)
    print(engine_line("engine S", rep_s) + " agreement with engine A: "
          f"{rep_s['agreement_with_a']} teacher_forced window vs steps="
          f"{rep_s['teacher_forced']}", flush=True)

    # ---- 5c. the prefix cache on float and int8 pages (8 requests: the
    # script's time limit); 5d. beam search
    prefix = run_prefix(eng, tmodel, params, rng, wrappers, n_req=8)
    beam = run_beam(torch, ttr, tmm, tmodel, params, wrappers)

    # ---- 5e'. the analysis tier's runtime guards (15j): refusal and
    # scope, two engines at once, the guard's cost, a planted placement
    guards = run_guards(torch, eng, tmodel, params, wrappers, card)
    del tmodel, params
    torch.cuda.empty_cache()

    # ---- 5g. two engines behind the prefix-affinity router, SLOs, the
    # control plane and a process replica
    router = run_router(torch, eng, wrappers, card)
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
    torch.cuda.empty_cache()

    # ---- 8b'. the online loop: serve into a capture store, fine-tune,
    # publish, hot-reload, and roll a poisoned round back
    online = run_online(torch, ttr, eng, wrappers, rng)
    torch.cuda.empty_cache()

    # ---- 8c. the DL4J network stack: the CLI's DBN, the same fit in
    # process, kernel #4 on its head, card against CPU
    dl4j, dl4j_leg = run_dl4j(torch, txe, wrappers, rates, cases, card)
    torch.cuda.empty_cache()

    # ---- 8d. ResNet-50 training at batch 256 x 224^2; 8e. the LSTM
    # sequence model; 8f. the text pipeline and the svmlight records
    # (no kernel of the port lies on these paths: their counts stay 0)
    resnet = run_resnet(torch, TT, wrappers, rates, card)
    torch.cuda.empty_cache()
    lstm = run_lstm(torch, wrappers, card)
    text, w2v, topic_words = run_text(torch, wrappers, card)
    torch.cuda.empty_cache()

    # ---- 8g. raw text to a trained RNTN; 8h. k-means, exact t-SNE and
    # the render server over the Word2Vec table (no kernel of the port
    # lies on these paths either)
    trees = run_trees(torch, wrappers, card)
    embed = run_embed_plot(torch, wrappers, card, w2v, topic_words)
    del w2v
    torch.cuda.empty_cache()

    # ---- 8i. the data-parallel tier at leg A's width: one rank over
    # NCCL here, two and four ranks over gloo on the card (the ZeRO
    # stages, hogwild, a checkpoint across widths, elastic shrink/grow)
    # ---- 8j. the model-parallel axes at the flagship's width, on 15g's
    # four elastic ranks (one start-up less): tp, sp with the ring, the
    # GPipe pipeline with ZeRO-1 and a checkpoint to one device,
    # ep-split embeddings, beside the eight-rank sharding dryrun
    mp_run = MPRun(root)
    try:
        dp = run_data_parallel(torch, wrappers, card, mp=mp_run)
        mp = mp_report(torch, wrappers, card, dp.pop("mp_ranks"), mp_run,
                       dp["mp_s"])
    finally:
        mp_run.close()
    torch.cuda.empty_cache()

    # ---- 8k. the host control plane: the Driver at leg A's width over one
    # NCCL rank (bitwise the bare trainer's fit, status mid-run, resume,
    # supervised retry), the scaleout word2vec on the card, the process
    # runner with the elastic wave, and the scaleout / provision CLI
    ctl = run_control_plane(torch, wrappers, card, root)
    torch.cuda.empty_cache()

    # ---- 9. one line per kernel: its numbers weighted by this run's
    # launches at each main-path shape, and every shape measured
    kernels = kernel_rows(
        cases, [rep_a, rep_b, rep_f, disagg["float"], disagg["fp8"], rep_s,
                prefix["float"]["cache"], prefix["int8"]["cache"], beam,
                router, ckpt["serve"], ckpt["reload"], online["serve"]],
        [leg_a, leg_b, sample["bfloat16"], scorer, ckpt["leg"],
         online["leg"], dl4j_leg] + dp["legs"] + mp["legs"] + ctl["legs"],
        mcfg, rates)
    if args.report:
        path = Path(args.report)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({
            "card": card, "device": name, "build_s": build_s,
            "ptxas": usage,
            "kernel_cases": cases, "int8_matmul_dx_err": int8_dx,
            "int8_matmul_device_kernels": int8_kernels,
            "engine_a": rep_a, "engine_b": rep_b, "engine_f": rep_f,
            "disagg": disagg, "online": online, "engine_s": rep_s,
            "prefix": prefix, "beam": beam, "router": router,
            "sample": sample,
            "scorer": scorer, "train_a": leg_a, "train_b": leg_b,
            "step_vs_plain": {"train_a": step_a, "train_b": step_b},
            "checkpoints": ckpt, "dl4j": dl4j, "resnet": resnet,
            "lstm": lstm, "text": text, "trees": trees, "embed": embed,
            "data_parallel": dp, "model_parallel": mp,
            "control_plane": ctl, "guards": guards, "kernels": kernels},
            indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
