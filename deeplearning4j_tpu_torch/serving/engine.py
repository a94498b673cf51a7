"""Continuous-batching inference engine.

Port of ``InferenceEngine`` from ``deeplearning4j_tpu/serving/engine.py``.
The KV cache is a pool of ``slots`` rows — dense ``(S, max_len, Kv, Dh)``
per layer, or, with ``paged=True``, fixed-size pages in a shared pool
addressed through per-slot block tables.  Every decode step advances ALL
occupied slots one token with per-slot positions; new sequences are
admitted into free rows between decode segments (prefill on a batch-of-1
cache, then one scatter into the pool), and a finished sequence (EOS or
length budget) frees its row for the next arrival.

Hot-loop rule: ``_decode_segment`` launches ``resolve_every`` steps
back-to-back with no ``.item()``, ``.cpu()`` or ``.tolist()``; the emitted
tokens stay on the device until ``_resolve`` pulls the whole segment in
ONE copy, where EOS/length bookkeeping, admissions and metrics happen.
The device state (token buffer, positions, caches) is updated in place —
where the JAX package donated its state buffers.

Token contract: greedy requests decode exactly as
``TransformerLM.sample(..., kv_cache=True)``.  Sampled requests draw from a
per-request ``torch.Generator`` seeded with the request's ``seed``, one
draw of ``V`` uniforms per generated token in token order
(:func:`~..models.transformer.sample_token`), so they equal the offline
sampler with the same seed.  A speculative step emits a number of tokens
that only the device knows, so the engine draws AHEAD: before each step
the host tops up a per-slot ring of noise rows on the device (row ``g``
holds generated token ``g``'s draw, as many rows as the step could
consume), and the device reads the rows at its own token offset.

Prefill runs the prompt token by token through the same ``decode_step``
as the offline sampler; the power-of-two prompt bucket ladder of the JAX
package (one compiled prefill per bucket) is kept only as bookkeeping
(``stats()["prefill_buckets"]``).

Also here: the prefix cache (``prefix_cache=True``: a shared prompt
prefix is admitted by block-table aliasing and its prefill skipped),
speculative decoding (``speculative=True``: a draft proposes ``spec_k``
greedy tokens, one ``decode_window(_paged)`` pass of the target verifies
them), the brownout setters, :class:`BatchScorer`, and serving from a
checkpoint directory with hot reload (:meth:`InferenceEngine.reload`).

Generation consistency: ``reload()`` restores the new tree off the serve
thread and STAGES it; the swap applies only at a fence with every slot
free, and admission pauses while a swap is staged.  So in-flight requests
finish wholly under the old weights and queued ones decode wholly under
the new, and every completion's ``generation``/``loaded_step`` stamp is
exact.

Not ported yet: ``role != "unified"`` (raises ``NotImplementedError``),
fp8 KV pages, tracing, the flight recorder, cost capture, per-tenant
accounting and the chaos sites.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import (cast_for_decode, decode_step,
                                  decode_step_paged, decode_window,
                                  decode_window_paged, gather_paged_layer,
                                  gumbel_noise, init_decode_cache,
                                  init_paged_cache, paged_flat_index,
                                  reset_cache_pages, reset_cache_slots,
                                  scatter_paged_layer, scatter_rows)
from ..observability.metrics import MetricsRegistry
from ..ops.cuda import build, kv_quant, registry
from ..parallel.checkpoint import CheckpointManager
from ..ops.cuda.matmul_int8 import quantize_params_for_decode
from .batcher import (Completion, GenerateRequest, PagePoolExhausted,
                      PendingResult, RequestQueue, ScoreRequest)
from .paging import PagePool

#: unit-interval buckets for fill-ratio histograms
FILL_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

#: the JAX package's kernel names, accepted so serving configs port as-is
IMPL_ALIASES = {"pallas": "cuda", "pallas_int8": "cuda_int8"}


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Engine knobs (the model's own shape lives in TransformerConfig)."""

    slots: int = 4                  # concurrent sequences in the device batch
    resolve_every: int = 4          # decode steps launched per host fence
    max_queue: int = 64             # RequestQueue bound (429 beyond)
    max_batch_delay_ms: float = 2.0  # idle coalescing window
    min_prefill_bucket: int = 8     # floor of the prompt bucket ladder
    idle_wait_s: float = 0.05       # queue wait while no slot is live
    default_eos_id: int | None = None
    int8_decode: bool = False       # serve int8 weight-quantized FFN/head
    paged: bool = False             # page-pool KV instead of dense slot rows
    page_size: int = 16             # tokens per KV page
    num_pages: int | None = None    # pool capacity; None -> slots*ceil(T/ps)
    prefix_cache: bool = False      # content-addressed prefix sharing (paged)
    speculative: bool = False       # draft proposes, target verifies
    spec_k: int = 3                 # draft tokens proposed per verify window
    paged_attention_impl: str = "gather"  # "gather" (plain torch) or a
    #                                 registry candidate: "cuda" /
    #                                 "cuda_int8" (aliases "pallas" /
    #                                 "pallas_int8")
    kv_quant: str | None = None     # None = model dtype, "int8" = per-page
    #                                 per-head absmax int8 (needs paged)
    role: str = "unified"           # only "unified" is ported (the
    #                                 prefill/decode roles: ROADMAP.md A8)


def kv_page_bytes(mcfg, page_size: int, kv_quant: str | None = None) -> int:
    """Device bytes one KV page costs across all layers: K+V data at the
    storage itemsize plus, when quantized, the f32 per-page scales.
    ``kv_quant`` is the storage mode, as ``ServingConfig.kv_quant``."""
    from ..ops.cuda import kv_quant as kvq
    kvh = mcfg.kv_heads
    item = kvq.kv_itemsize(kv_quant, mcfg.dtype)
    per_layer = page_size * kvh * mcfg.head_dim * 2 * item
    if kv_quant is not None:
        per_layer += 2 * kvh * 4   # k_scale + v_scale rows, f32
    return per_layer * mcfg.n_layers


@dataclasses.dataclass
class _Slot:
    """Host-side record of one occupied cache row."""

    pending: PendingResult
    delivered: list = dataclasses.field(default_factory=list)
    admitted_s: float = 0.0
    first_token_s: float | None = None
    gen: torch.Generator | None = None   # sampled requests only
    drawn: int = 0                 # noise rows drawn ahead
    # weight generation this request was admitted (and fully decodes)
    # under: swaps apply only at fences with every slot free
    generation: int = 0
    loaded_step: int | None = None


class InferenceEngine:
    """Continuous-batching decode over a ``TransformerLM``'s parameters.

    The JAX package's parameter order: ``params`` must already live on
    ``device`` (default ``cuda``, which raises when there is no GPU), or
    come from ``checkpoint`` (a directory, opened read-only, or a
    :class:`~..parallel.checkpoint.CheckpointManager`), restored at
    ``latest_valid_step()``; ``model.init`` shapes the restore template,
    so the checkpoint must match ``model.cfg``.  A speculative engine
    takes ``draft_model`` and ``draft_params`` (``models.zoo.draft_lm``),
    sharing the target's vocabulary and ``max_len``.  ``registry`` is the
    metrics registry the engine publishes to (a fresh one by default;
    ``ModelServer`` serves it)."""

    def __init__(self, model, params=None, checkpoint=None,
                 cfg: ServingConfig = ServingConfig(), draft_model=None,
                 draft_params=None, *, device=None,
                 registry: MetricsRegistry | None = None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.metrics = registry if registry is not None else MetricsRegistry()
        if cfg.role != "unified":
            raise NotImplementedError(
                f"role={cfg.role!r}: the prefill/decode roles are not "
                "ported to deeplearning4j_tpu_torch yet (ROADMAP.md A8)")
        if cfg.prefix_cache and not cfg.paged:
            raise ValueError("prefix_cache requires paged=True (sharing is "
                             "block-table aliasing)")
        if cfg.kv_quant is not None:
            if not cfg.paged:
                raise ValueError("kv_quant requires paged=True (scales live "
                                 "beside the page pool)")
            kv_quant.storage_dtype(cfg.kv_quant)  # validates the mode
        if cfg.speculative:
            if draft_model is None or draft_params is None:
                raise ValueError("speculative=True needs draft_model and "
                                 "draft_params (see zoo.draft_lm)")
            if (draft_model.cfg.vocab_size != model.cfg.vocab_size
                    or draft_model.cfg.max_len != model.cfg.max_len):
                raise ValueError("draft model must share the target's "
                                 "vocab_size and max_len")
            if cfg.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
        self._ckpt: CheckpointManager | None = None
        self._loaded_step: int | None = None
        if checkpoint is not None:
            self._ckpt = (checkpoint if isinstance(checkpoint,
                                                   CheckpointManager)
                          else CheckpointManager.open_read_only(checkpoint))
        if params is None:
            if self._ckpt is None:
                raise ValueError("need params or a checkpoint to serve from")
            template = model.init(
                torch.Generator(device=self.device).manual_seed(0))
            try:
                # the walk-back restore verifies the newest valid step once
                # (the reference verifies it twice: listing, then restore)
                restored = self._ckpt.restore(template)
            except FileNotFoundError as e:
                raise FileNotFoundError(
                    f"no verified checkpoint under {self._ckpt.directory}"
                ) from e
            params = restored["params"]
            self._loaded_step = restored["step"]
        mcfg = model.cfg
        self._draft_model = draft_model if cfg.speculative else None
        self._draft_params = (cast_for_decode(draft_params, draft_model.cfg)
                              if cfg.speculative else None)
        # tokens a step can emit (a verify window is spec_k + 1), and the
        # noise rows a segment can consume
        self._window = cfg.spec_k + 1 if cfg.speculative else 1
        self._ring = self._window * cfg.resolve_every
        self._page_size = cfg.page_size
        self._pages_per_slot = -(-mcfg.max_len // cfg.page_size)
        self._num_pages = (cfg.num_pages if cfg.num_pages is not None
                           else cfg.slots * self._pages_per_slot)
        self._pool = (PagePool(self._num_pages, cfg.page_size)
                      if cfg.paged else None)
        self._page_bytes = kv_page_bytes(mcfg, cfg.page_size, cfg.kv_quant)
        self._queue = RequestQueue(cfg.max_queue, cfg.max_batch_delay_ms,
                                   metrics=self.metrics)
        self._attn_fn = self._paged_attn_fn() if cfg.paged else None
        # _lock guards the slot bookkeeping shared between the serve thread
        # and callers (stop/stats/HTTP handlers); _state is serve-thread-
        # owned (warmup and stop touch it only while no serve thread runs)
        self._lock = threading.Lock()
        # _raw_params is the unquantized tree (also the reload restore
        # template: checkpoints hold no int8 leaves); _params is what
        # decode reads
        self._raw_params = params                    # guarded-by: self._lock
        self._params = self._maybe_quantize(params)  # guarded-by: self._lock
        # _generation counts applied swaps; _staged is the (raw, serving
        # tree, step) a reload parked for the next all-slots-free fence
        self._generation = 0                         # guarded-by: self._lock
        self._staged: tuple | None = None            # guarded-by: self._lock
        # pages quarantined by reload's clear_prefix: the serve thread
        # wipes them at its next fence, then requeues them
        self._pending_wipe: list[int] = []           # guarded-by: self._lock
        self._rows = torch.arange(cfg.slots, device=self.device)
        self._offsets = torch.arange(self._window, device=self.device,
                                     dtype=torch.int32)
        self._state = self._init_state()
        self._warmed = False
        self._spec_enabled = cfg.speculative         # guarded-by: self._lock
        self._max_new_cap: int | None = None         # guarded-by: self._lock
        self._admission_hook = None                  # guarded-by: self._lock
        self._buckets: set[int] = set()              # guarded-by: self._lock
        self._slots: dict[int, _Slot] = {}           # guarded-by: self._lock
        self._slot_pages: dict[int, list[int]] = {}  # guarded-by: self._lock
        self._free: list[int] = list(range(cfg.slots))  # guarded-by: self._lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._admitted = 0                           # guarded-by: self._lock
        self._completed = 0                          # guarded-by: self._lock
        self._last_error: str | None = None          # guarded-by: self._lock
        self._publish_generation_gauges()

    def _maybe_quantize(self, params):
        """The serving tree decode reads: with ``int8_decode`` the FFN
        w1/w2 and the LM head become int8 + per-channel scales; matmul
        operands are cast to the compute dtype once
        (:func:`~..models.transformer.cast_for_decode`).  The draft's
        tree is cast, never quantized."""
        mcfg = self.model.cfg
        with self.metrics.time("serving.quantize"), torch.no_grad():
            if self.cfg.int8_decode:
                params = quantize_params_for_decode(params, mcfg)
            return cast_for_decode(params, mcfg)

    # ------------------------------------------------------------ device state
    def _init_state(self) -> dict:
        mcfg = self.model.cfg
        S = self.cfg.slots
        dev = self.device

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        state = {
            "toks": zeros((S, mcfg.max_len), torch.int32),
            "pos": zeros((S,), torch.int32),
            "limit": zeros((S,), torch.int32),
            "active": zeros((S,), torch.bool),
        }
        if self.cfg.paged:
            # +1 physical page: the trash page every inactive block-table
            # row points at, so masked writes never land on real pages
            if self.cfg.kv_quant is not None:
                state["pages"] = kv_quant.init_quantized_paged_cache(
                    mcfg, self._num_pages + 1, self._page_size,
                    self.cfg.kv_quant, dev)
            else:
                state["pages"] = init_paged_cache(
                    mcfg, self._num_pages + 1, self._page_size, dev)
            state["bt"] = torch.full((S, self._pages_per_slot),
                                     self._num_pages, dtype=torch.int32,
                                     device=dev)
        else:
            state["cache"] = init_decode_cache(mcfg, S, dev)
        if self.cfg.speculative:
            state["draft_cache"] = init_decode_cache(self._draft_model.cfg,
                                                     S, dev)
        # sampled slots' noise rows drawn ahead (row g % ring holds
        # generated token g's), and each slot's first generating position
        state["noise"] = zeros((S, self._ring, mcfg.vocab_size),
                               torch.float32)
        state["gbase"] = zeros((S,), torch.int32)
        return state

    def _paged_attn_fn(self):
        """The paged-attention read of the step: None selects the plain
        gather path; any other name resolves a registry candidate."""
        impl = self.cfg.paged_attention_impl
        if impl == "gather":
            return None
        kind = ("paged_attention_int8" if self.cfg.kv_quant is not None
                else "paged_attention")
        return registry.get(kind, IMPL_ALIASES.get(impl, impl)).fn

    def _picks(self, logits, sampled) -> torch.Tensor:
        """Token picks (S, W) int32 from the logits (S, W, V) of a step:
        the argmax, except for the ``sampled`` slots ``(slot,
        temperature)``, whose window position w reads the noise row of
        generated token ``pos - gbase + w`` (drawn ahead by
        :meth:`_plan_step`): ``sample_token``'s arithmetic on its
        draw."""
        pick = torch.argmax(logits, dim=-1).to(torch.int32)
        st = self._state
        W = logits.shape[1]
        for s, temp in sampled:
            g = (st["pos"][s] - st["gbase"][s]) + self._offsets[:W]
            noise = st["noise"][s, (g % self._ring).long()]      # (W, V)
            pick[s] = torch.argmax(logits[s].float() / temp - noise,
                                   dim=-1).to(torch.int32)
        return pick

    def _step(self, params, sampled) -> torch.Tensor:
        """Advance every occupied slot one token; returns the emitted ids
        (S,) int32 on the device, -1 for rows that did not generate.

        Inactive / exhausted rows still flow through the batched matmuls
        (masked no-ops), but their positions and token buffers are frozen.
        ``sampled`` lists the sampled slots (:meth:`_picks`)."""
        mcfg = self.model.cfg
        st = self._state
        pos, active, limit, toks = (st["pos"], st["active"], st["limit"],
                                    st["toks"])
        rows = self._rows
        cur = toks[rows, pos.long()]
        if self.cfg.paged:
            logits, _ = decode_step_paged(params, st["pages"], st["bt"], cur,
                                          pos, mcfg, attn_fn=self._attn_fn)
        else:
            logits, _ = decode_step(params, st["cache"], cur, pos, mcfg)
        pick = self._picks(logits[:, None], sampled)[:, 0]
        can = active & (pos < limit) & (pos + 1 < mcfg.max_len)
        emitted = torch.where(can, pick, torch.full_like(pick, -1))
        new_pos = torch.where(can, pos + 1, pos)
        idx = new_pos.long()
        toks[rows, idx] = torch.where(can, pick, toks[rows, idx])
        pos.copy_(new_pos)
        return emitted

    def _spec_step(self, params, sampled) -> torch.Tensor:
        """One speculative dispatch: the draft proposes ``spec_k`` greedy
        tokens, one verify window (``decode_window_paged`` or
        ``decode_window``) scores ``[cur, proposals]`` on the target, and
        up to ``spec_k + 1`` tokens emit.  Returns the emitted ids (S, W)
        int32, -1 where nothing emitted.

        Window logit ``L_i`` is the target's next-token distribution at
        ``pos + i``, so pick ``i`` is what a sequential step would pick
        (same draw for sampled slots, :meth:`_picks`); pick ``i`` emits
        only while every earlier proposal matched its pick (``cumprod`` of
        ``can & match``), and the position advances by the count m.  The
        draft decides how many tokens emit, never which.  (The JAX
        package's chaos term garbling proposals comes with
        ``resilience/faults.py``; here it is always 0.)"""
        mcfg = self.model.cfg
        T = mcfg.max_len
        st = self._state
        pos, active, limit, toks = (st["pos"], st["active"], st["limit"],
                                    st["toks"])
        S, k = self.cfg.slots, self.cfg.spec_k
        rows = self._rows
        cur = toks[rows, pos.long()]
        proposals, inp = [], cur
        for i in range(k):
            # past max_len the draft writes its last row again: only its
            # proposals degrade, and they decide nothing that emits
            d_logits, _ = decode_step(self._draft_params, st["draft_cache"],
                                      inp, torch.clamp(pos + i, max=T - 1),
                                      self._draft_model.cfg)
            inp = torch.argmax(d_logits, dim=-1).to(torch.int32)
            proposals.append(inp)
        d = torch.stack(proposals, dim=1)                       # (S, k)
        window = torch.cat([cur[:, None], d], dim=1)            # (S, W)
        if self.cfg.paged:
            logits, _ = decode_window_paged(params, st["pages"], st["bt"],
                                            window, pos, mcfg)
        else:
            logits, _ = decode_window(params, st["cache"], window, pos, mcfg)
        picks = self._picks(logits, sampled)                    # (S, W)
        p2 = pos[:, None] + self._offsets[None, :]
        can = active[:, None] & (p2 < limit[:, None]) & (p2 + 1 < T)
        match = torch.cat([torch.ones_like(can[:, :1]),
                           d == picks[:, :k]], dim=1)
        emit = torch.cumprod((can & match).to(torch.int32), dim=1).bool()
        m = emit.sum(dim=1).to(torch.int32)
        emitted = torch.where(emit, picks, torch.full_like(picks, -1))
        flat = torch.where(emit, rows[:, None] * T + p2 + 1,
                           torch.full_like(p2, S * T))
        scatter_rows(toks.view(-1), flat.reshape(-1), picks.reshape(-1))
        pos.add_(m)
        return emitted

    # ------------------------------------------------------------ prefill
    def _prompt_bucket(self, n: int) -> int:
        """Power-of-two prompt ladder (bookkeeping only in this port)."""
        b = self.cfg.min_prefill_bucket
        while b < n:
            b <<= 1
        return min(b, self.model.cfg.max_len)

    def _prefill(self, params, slot: int, req: GenerateRequest,
                 cached_len: int = 0) -> None:
        """Run ``prompt[:-1]`` through ``decode_step`` on a batch-of-1
        cache — the offline sampler's own arithmetic — then write the row
        into the slot pool (dense) or the slot's pages (paged; quantized
        pools quantize at that write), and arm the slot's state.

        Paged: the batch-of-1 cache starts as a gather of the slot's
        block-table row, so positions below ``cached_len`` (aliased
        prefix pages) are already there and skipped; the write back
        rewrites shared pages with the values they hold (the same bytes
        for int8 pages: their scales are monotone).  A speculative
        engine prefills the draft's dense row beside the target, always
        from position 0 (the prefix cache holds target pages only)."""
        mcfg = self.model.cfg
        st = self._state
        p_len = len(req.prompt)
        prompt = torch.tensor(req.prompt, dtype=torch.long, device=self.device)
        if self.cfg.paged:
            bt_row = st["bt"][slot:slot + 1]
            # a quantized pool gathers DEQUANTIZED content, so the prefill
            # loop below runs the same float arithmetic either way
            cache1 = [dict(zip(("k", "v"), gather_paged_layer(
                c, bt_row, mcfg.max_len, mcfg.dtype))) for c in st["pages"]]
        else:
            cache1 = init_decode_cache(mcfg, 1, self.device)
        spec = self.cfg.speculative
        if spec:
            dcfg = self._draft_model.cfg
            dcache1 = init_decode_cache(dcfg, 1, self.device)
        for i in range(p_len - 1):
            if i >= cached_len:
                decode_step(params, cache1, prompt[i:i + 1], i, mcfg)
            if spec:
                decode_step(self._draft_params, dcache1, prompt[i:i + 1], i,
                            dcfg)
        if self.cfg.paged:
            t = torch.arange(mcfg.max_len, device=self.device)[None, :]
            flat = paged_flat_index(bt_row, t, self._page_size)[0]
            for c, c1 in zip(st["pages"], cache1):
                scatter_paged_layer(c, flat, c1["k"][0], c1["v"][0])
        else:
            for c, c1 in zip(st["cache"], cache1):
                c["k"][slot] = c1["k"][0]
                c["v"][slot] = c1["v"][0]
        if spec:
            for c, c1 in zip(st["draft_cache"], dcache1):
                c["k"][slot] = c1["k"][0]
                c["v"][slot] = c1["v"][0]
        st["gbase"][slot] = p_len - 1
        st["toks"][slot].zero_()
        st["toks"][slot, :p_len] = prompt.to(torch.int32)
        # the first engine step processes token p_len-1 and draws token p_len
        st["pos"][slot] = p_len - 1
        st["limit"][slot] = p_len - 1 + req.max_new_tokens
        st["active"][slot] = True

    # ------------------------------------------------------------ submission
    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               seed: int = 0, eos_id: int | None = None,
               deadline_ms: float | None = None,
               tenant: str = "", priority: int = 0) -> PendingResult:
        """Validate + enqueue; returns a handle whose ``result()`` blocks.
        Raises ``ValueError`` on malformed requests (HTTP 400) and
        :class:`~.batcher.QueueFull` under backpressure (HTTP 429).
        ``tenant`` is an opaque caller identity carried on the request
        (per-tenant accounting needs the observability registries,
        ROADMAP.md A7).  ``priority`` > 0 marks background work, claimed
        only while no interactive request waits.  A brownout cap
        (:meth:`set_max_new_cap`) clamps ``max_new_tokens``, and an
        admission hook (:meth:`set_admission_hook`) may reject the
        validated request by raising."""
        mcfg = self.model.cfg
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(not 0 <= t < mcfg.vocab_size for t in prompt):
            raise ValueError(
                f"prompt token out of range [0, {mcfg.vocab_size})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > mcfg.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len ({mcfg.max_len})")
        with self._lock:
            cap = self._max_new_cap
            hook = self._admission_hook
        if cap is not None and max_new_tokens > cap:
            # a shorter completion instead of a rejection: the tokens are
            # the prefix of the uncapped ones
            max_new_tokens = cap
            self.metrics.increment("serving.max_new_clamped")
        req = GenerateRequest(
            prompt=prompt, max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), seed=int(seed),
            eos_id=eos_id if eos_id is not None else self.cfg.default_eos_id,
            deadline_s=(time.monotonic() + deadline_ms / 1000.0
                        if deadline_ms else None),
            tenant=str(tenant) if tenant else "",
            priority=1 if int(priority) > 0 else 0)
        if hook is not None:
            hook(req)
        self.metrics.increment("serving.requests")
        return self._queue.submit(req)

    def generate(self, prompt, max_new_tokens: int, timeout: float = 60.0,
                 **kw) -> Completion:
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(prompt, max_new_tokens, **kw).result(timeout)

    # ------------------------------------------------------------ serve loop
    def start(self, warmup: bool = True) -> "InferenceEngine":
        if self._thread is not None:
            return self
        if warmup:
            self.warmup()
        self._stop.clear()
        self._thread = threading.Thread(target=self._serve_loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._queue.wake()   # kick the serve loop out of its idle wait
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        with self._lock:
            dead = {s: self._slots.pop(s) for s in list(self._slots)}
            pages = {s: self._slot_pages.pop(s, [])
                     for s in list(self._slot_pages)}
            self._free = list(range(self.cfg.slots))
        for sl in dead.values():
            sl.pending._fail(
                RuntimeError("engine stopped with request in flight"))
        # the serve thread is joined, so _state is safe to touch: reset the
        # dead rows the way _evict would have
        if dead:
            with torch.no_grad():
                for s in dead:
                    self._release_row(s, pages.get(s, []))
        for p in self._queue.drain():
            p._fail(RuntimeError("engine stopped before request was admitted"))

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def warmup(self) -> None:
        """Build and load the CUDA kernels (on a GPU) and run one decode
        step over the all-inactive state (a speculative engine runs its
        plain step too, the brownout fallback), so the first request pays
        no build or first-launch cost."""
        with self.metrics.time("serving.warmup"), torch.no_grad():
            if self.device.type == "cuda":
                build.build_all()
            with self._lock:
                params = self._params
            if self.cfg.speculative:
                self._spec_step(params, []).cpu()
            self._step(params, []).cpu()
        self._warmed = True

    def _release_row(self, s: int, pages: list[int]) -> None:
        """Deactivate row ``s`` and release its K/V: paged engines decref
        its pages (wiping those that reach zero) and park its block-table
        row on the trash page; dense engines wipe the cache row."""
        st = self._state
        st["active"][s] = False
        if self.cfg.paged:
            st["bt"][s] = self._num_pages
            self._wipe_pages(self._pool.decref(pages))
        else:
            mask = torch.zeros((self.cfg.slots,), dtype=torch.bool,
                               device=self.device)
            mask[s] = True
            reset_cache_slots(st["cache"], mask)

    def _wipe_pages(self, freed: list[int]) -> None:
        """Zero physical pages whose refcount just hit zero."""
        if not freed:
            return
        mask = torch.zeros((self._num_pages + 1,), dtype=torch.bool,
                           device=self.device)
        mask[torch.tensor(freed, device=self.device)] = True
        reset_cache_pages(self._state["pages"], mask)

    def _serve_loop(self) -> None:
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    self._serve_once()
                except Exception as e:  # a wedged loop strands callers
                    self.metrics.increment("serving.engine.errors")
                    with self._lock:
                        self._last_error = traceback.format_exc()
                        dead = [self._slots.pop(s) for s in list(self._slots)]
                        self._slot_pages.clear()
                        self._free = list(range(self.cfg.slots))
                    for sl in dead:
                        sl.pending._fail(e)
                    if self._pool is not None:
                        self._pool.reset()
                        with self._lock:
                            self._pending_wipe = []
                    self._state = self._init_state()

    def _drain_pending_wipe(self) -> None:
        """Serve-thread half of reload's prefix invalidation: zero the
        pages :meth:`PagePool.clear_prefix` quarantined, and only then
        hand them back to the free list (wipe before reallocatable, and
        here because ``_state`` is serve-thread-owned)."""
        with self._lock:
            pending, self._pending_wipe = self._pending_wipe, []
        if pending:
            self._wipe_pages(pending)
            self._pool.requeue(pending)

    def _serve_once(self) -> None:
        self._drain_pending_wipe()
        with self._lock:
            applied = self._try_apply_staged_locked()
            staged = self._staged is not None
        if applied:
            self._publish_generation_gauges()
        idle = not self._slots
        n_free = len(self._free)
        if n_free and not staged:
            # admission pauses while a swap is staged: in-flight slots
            # drain, the fence arrives, and queued requests then decode
            # wholly under the NEW generation
            batch = self._queue.take(
                n_free, block_s=self.cfg.idle_wait_s if idle else 0.0)
            if batch:
                self._admit(batch)
        if not self._slots:
            return
        self.metrics.observe_time("serving.batch_fill_ratio",
                                  len(self._slots) / self.cfg.slots,
                                  buckets=FILL_BUCKETS)
        t0 = time.perf_counter()
        pending = self._decode_segment()
        self._resolve(pending, t0)

    def _admit(self, batch: list[PendingResult]) -> None:
        for p in batch:
            if not self._queue.claim(p):
                continue
            req: GenerateRequest = p.request
            with self._lock:
                slot = self._free.pop()
                params = self._params
                # the generation stamp is atomic with the params capture
                gen_id, lstep = self._generation, self._loaded_step
                self._buckets.add(self._prompt_bucket(len(req.prompt)))
            acquired: list[int] = []
            try:
                cached_len = 0
                usable = len(req.prompt) - 1
                if self.cfg.paged:
                    if self.cfg.prefix_cache:
                        # alias the longest cached chain of the prompt's
                        # full pages (increffed for this slot); atomic with
                        # a params re-capture, since a swap clears the
                        # cache under this lock: every entry seen here
                        # holds K/V computed under exactly `params`
                        with self._lock:
                            params = self._params
                            gen_id, lstep = (self._generation,
                                             self._loaded_step)
                            shared, cached_len = self._pool.lookup_prefix(
                                req.prompt, usable)
                        acquired.extend(shared)
                    # allocate for what THIS request can touch (positions
                    # [0, limit]); the row's tail parks on the trash page
                    need = -(-(len(req.prompt) + req.max_new_tokens)
                             // self._page_size)
                    acquired.extend(self._pool.alloc(need - len(acquired)))
                    row = acquired + [self._num_pages] * (
                        self._pages_per_slot - len(acquired))
                    self._state["bt"][slot] = torch.tensor(
                        row, dtype=torch.int32)
                t_pre = time.perf_counter()
                self._prefill(params, slot, req, cached_len)
                self.metrics.observe_time("serving.prefill",
                                          time.perf_counter() - t_pre)
                if self.cfg.prefix_cache:
                    # publish every full-page chain of this prompt; the
                    # entries pin their pages with their own refcounts.
                    # Skipped when a swap applied mid-prefill: these pages
                    # hold old-weight K/V the cleared cache must not learn
                    with self._lock:
                        if self._params is params:
                            self._pool.insert_prefix(req.prompt, acquired,
                                                     usable)
                    if cached_len:
                        self.metrics.increment("serving.prefix_hits")
                        # prompt positions whose prefill the cache saved
                        self.metrics.increment("serving.prefix_cached_tokens",
                                               cached_len)
            except Exception as e:
                # fail only THIS request; the slot and its pages go back
                # (an aliased page keeps its other readers' references)
                self._release_row(slot, acquired)
                with self._lock:
                    self._free.append(slot)
                self.metrics.increment(
                    "serving.page_pool_exhausted"
                    if isinstance(e, PagePoolExhausted)
                    else "serving.engine.errors")
                p._fail(e)
                continue
            gen = None
            if req.temperature > 0:
                gen = torch.Generator(device=self.device).manual_seed(req.seed)
            with self._lock:
                self._slots[slot] = _Slot(pending=p,
                                          admitted_s=time.monotonic(),
                                          gen=gen, generation=gen_id,
                                          loaded_step=lstep)
                self._slot_pages[slot] = acquired
                self._admitted += 1
            self.metrics.increment("serving.admitted")
            self._publish_kv_gauges()

    def _publish_kv_gauges(self) -> None:
        """Device-KV footprint gauges at admission/eviction fences."""
        mcfg = self.model.cfg
        m = self.metrics
        m.gauge("serving.kv_quant_bits",
                kv_quant.kv_itemsize(self.cfg.kv_quant, mcfg.dtype) * 8)
        if self._pool is None:
            dense = (mcfg.max_len * mcfg.kv_heads * mcfg.head_dim * 2
                     * mcfg.n_layers
                     * torch.empty((), dtype=mcfg.dtype).element_size())
            m.gauge("serving.kv_bytes", dense * self.cfg.slots)
            m.gauge("serving.kv_bytes_per_slot", dense)
            return
        in_use = self._pool.in_use()
        with self._lock:
            occupied = len(self._slots)
            slot_pages = {p for pages in self._slot_pages.values()
                          for p in pages}
        m.gauge("serving.kv_pages_in_use", in_use)
        m.gauge("serving.kv_pages_total", self._num_pages)
        m.gauge("serving.kv_page_bytes", self._page_bytes)
        m.gauge("serving.kv_bytes", in_use * self._page_bytes)
        m.gauge("serving.kv_bytes_per_slot",
                len(slot_pages) * self._page_bytes / occupied
                if occupied else 0.0)

    def _plan_step(self, width: int, j: int) -> list:
        """Host-side plan of the sampled draws of step ``j`` of a segment
        whose steps emit up to ``width`` tokens a slot.  Before step ``j``
        a slot has emitted at most ``len(delivered) + width * j`` tokens
        (delivered counts all it emitted before this segment), so each
        sampled slot's noise rows up to ``width`` beyond that bound (and
        below ``max_new_tokens``) are drawn now, each one ``torch.rand(V)``
        from the slot's generator in token order (``sample_token``'s
        draw), and stored as its Gumbel noise.  No host sync: the device
        reads the rows at its own offset.  Returns ``[(slot,
        temperature)]`` of the sampled slots."""
        sampled = []
        st = self._state
        V = self.model.cfg.vocab_size
        for s, sl in self._slots.items():
            if sl.gen is None:
                continue
            req = sl.pending.request
            want = min(req.max_new_tokens,
                       len(sl.delivered) + width * (j + 1))
            for g in range(sl.drawn, want):
                st["noise"][s, g % self._ring] = gumbel_noise(torch.rand(
                    (V,), generator=sl.gen, device=self.device,
                    dtype=torch.float32))
            sl.drawn = max(sl.drawn, want)
            sampled.append((s, req.temperature))
        return sampled

    def _decode_segment(self) -> list:
        """Launch ``resolve_every`` decode steps with NO host syncs — the
        emitted-token tensors stay on the device until ``_resolve``.  A
        speculative engine takes its spec step unless the brownout switch
        (:meth:`set_speculative`) turned it off, read once a segment."""
        with self._lock:
            params = self._params
            spec = self.cfg.speculative and self._spec_enabled
        out = []
        for j in range(self.cfg.resolve_every):
            if spec:
                out.append(self._spec_step(
                    params, self._plan_step(self._window, j)))
            else:
                out.append(self._step(params, self._plan_step(1, j))[:, None])
        self.metrics.increment("serving.decode.dispatches", len(out))
        return out

    def _resolve(self, pending: list, t0: float) -> None:
        """The per-segment fence: ONE host copy of the segment's emitted
        tokens, then EOS/length bookkeeping and metrics."""
        if not pending:
            return
        em = torch.stack(pending).cpu().numpy()              # (k, S, W)
        now = time.monotonic()
        seg_s = time.perf_counter() - t0
        n_steps = len(pending)
        self.metrics.observe_many("serving.decode_step",
                                  [seg_s / n_steps] * n_steps)
        if self.cfg.speculative:
            # tokens emitted per dispatch per live slot (clipped emissions
            # at the limit count too)
            counts = (em >= 0).sum(axis=2)
            self.metrics.observe_many(
                "serving.spec_accept_len",
                [float(c) for c in counts[counts > 0]],
                buckets=tuple(float(i)
                              for i in range(1, self.cfg.spec_k + 2)))
        delivered = 0
        for s in list(self._slots):
            sl = self._slots[s]
            req: GenerateRequest = sl.pending.request
            finish = None
            for t in em[:, s].reshape(-1):
                t = int(t)
                if t < 0:
                    continue
                delivered += 1
                if sl.first_token_s is None:
                    sl.first_token_s = now  # fence granularity
                    self.metrics.observe_time("serving.ttft",
                                              now - req.submitted_s)
                sl.delivered.append(t)
                if req.eos_id is not None and t == req.eos_id:
                    finish = "eos"
                    break
                if len(sl.delivered) >= req.max_new_tokens:
                    finish = "length"
                    break
            if finish is not None:
                self._evict(s, finish, now)
        if delivered:
            self.metrics.increment("serving.tokens", delivered)
            if seg_s > 0:
                self.metrics.gauge("serving.tokens_per_sec",
                                   delivered / seg_s)

    def _evict(self, s: int, finish: str, now: float) -> None:
        """Free slot ``s``: release its row, complete the caller."""
        with self._lock:
            sl = self._slots.pop(s)
            pages = self._slot_pages.pop(s, [])
            self._free.append(s)
            self._completed += 1
        self._release_row(s, pages)
        if self.cfg.paged:
            self._publish_kv_gauges()
        req = sl.pending.request
        self.metrics.increment("serving.completed")
        self.metrics.observe_time("serving.request_latency",
                                  now - req.submitted_s)
        sl.pending._complete(Completion(
            tokens=list(sl.delivered), finish_reason=finish,
            latency_s=now - req.submitted_s,
            ttft_s=(sl.first_token_s - req.submitted_s
                    if sl.first_token_s is not None else None),
            generation=sl.generation, loaded_step=sl.loaded_step))

    # ------------------------------------------------------------ hot reload
    def reload(self, step: int | None = None) -> int:
        """Hot swap to ``latest_valid_step()`` (or an explicit ``step``)
        without tearing any response: the new tree is restored and
        quantized on the caller's thread and STAGED; the swap applies only
        at a fence with every slot free (requests bound their own decode
        length, so the fence arrives within one request budget).  While a
        swap is staged admission pauses: in-flight requests finish wholly
        under the old generation and queued ones decode wholly under the
        new.  With ``prefix_cache`` every cached chain is dropped with the
        applied swap (its K/V came from the old weights); pages pinned
        only by the cache are wiped by the serve thread before they are
        allocatable again.  Returns the target step (applied, or staged
        for the next free fence).  Raises ``RuntimeError`` without a
        checkpoint and ``FileNotFoundError`` when nothing verifies."""
        if self._ckpt is None:
            raise RuntimeError("no checkpoint attached — nothing to reload")
        target = step if step is not None else self._ckpt.latest_valid_step()
        if target is None:
            raise FileNotFoundError(
                f"no verified checkpoint under {self._ckpt.directory}")
        with self._lock:
            if target == self._loaded_step:
                # already serving it — and cancel any staged swap away
                # from it (a rollback racing an un-applied reload)
                self._staged = None
                return target
            if self._staged is not None and self._staged[2] == target:
                return target  # same target already parked for the fence
            template = self._raw_params
        with self.metrics.time("serving.reload"), torch.no_grad():
            restored = self._ckpt.restore(template, step=target)
            new_params = self._maybe_quantize(restored["params"])
        with self._lock:
            self._staged = (restored["params"], new_params, target)
            applied = self._try_apply_staged_locked()
        self.metrics.increment("serving.reloads")
        if applied:
            self._publish_generation_gauges()
        return target

    def _try_apply_staged_locked(self) -> bool:
        """Apply a staged swap iff NO request holds a slot (``_free`` at
        full capacity also covers a request between its slot pop and its
        registration: the slot leaves ``_free`` under this lock before its
        prefill reads params).  Caller holds ``self._lock``."""
        if self._staged is None:
            return False
        if len(self._free) != self.cfg.slots:
            return False  # in-flight responses keep their generation
        raw, quantized, target = self._staged
        self._staged = None
        self._raw_params = raw
        self._params = quantized
        self._loaded_step = target
        self._generation += 1
        if self._pool is not None and self.cfg.prefix_cache:
            # in the swap's critical section: _admit's lookup (under this
            # lock too) never sees old-weight entries beside new params.
            # clear_prefix only quarantines pages; the serve thread wipes
            self._pending_wipe.extend(self._pool.clear_prefix())
        return True

    def _publish_generation_gauges(self) -> None:
        with self._lock:
            gen, step = self._generation, self._loaded_step
        self.metrics.gauge("serving.generation", gen)
        if step is not None:
            self.metrics.gauge("serving.loaded_step", step)

    # ------------------------------------------------------------ stats
    # ------------------------------------------------- brownout actuators
    def set_speculative(self, enabled: bool) -> bool:
        """Turn speculative decoding off (or back on) at runtime; returns
        the new effective state.  Read once a decode segment, and the
        draft decides only how many tokens emit, so served tokens are the
        same either way.  No-op on a plain engine."""
        if not self.cfg.speculative:
            return False
        with self._lock:
            self._spec_enabled = bool(enabled)
            now = self._spec_enabled
        self.metrics.gauge("serving.speculative_enabled", 1.0 if now else 0.0)
        return now

    def set_max_new_cap(self, cap: int | None) -> None:
        """Clamp every future request's ``max_new_tokens`` to ``cap`` at
        submission (``None`` lifts the clamp); admitted requests keep
        their budget."""
        if cap is not None and int(cap) < 1:
            raise ValueError(f"max_new cap must be >= 1, got {cap}")
        with self._lock:
            self._max_new_cap = int(cap) if cap is not None else None
        self.metrics.gauge("serving.max_new_cap",
                           float(cap) if cap is not None else 0.0)

    def set_admission_hook(self, hook) -> None:
        """Install (or clear, with ``None``) a gate called with each
        validated :class:`~.batcher.GenerateRequest` before it enters the
        queue; it rejects by raising a :class:`~.batcher.ServingRejected`
        subclass."""
        with self._lock:
            self._admission_hook = hook

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            out = {
                "slots": self.cfg.slots,
                "active": len(self._slots),
                "free": len(self._free),
                "queue_depth": self._queue.depth(),
                "admitted": self._admitted,
                "completed": self._completed,
                "loaded_step": self._loaded_step,
                "generation": self._generation,
                "reload_staged": self._staged is not None,
                "prefill_buckets": sorted(self._buckets),
                "running": self._thread is not None,
                "warmed": self._warmed,
                "role": self.cfg.role,
                "device": str(self.device),
                "last_error": self._last_error,
                "speculative_enabled": (self.cfg.speculative
                                        and self._spec_enabled),
                "max_new_cap": self._max_new_cap,
            }
        if self._pool is not None:
            out["kv_pages"] = self._num_pages
            out["kv_quant"] = self.cfg.kv_quant
            out["kv_page_bytes"] = self._page_bytes
            out["kv_pages_in_use"] = self._pool.in_use()
            out["prefix_entries"] = self._pool.prefix_entries()
            out["prefix_hit_rate"] = self._pool.hit_rate()
            hits, lookups = self._pool.hit_counts()
            out["prefix_hits"] = hits
            out["prefix_lookups"] = lookups
        return out


class BatchScorer:
    """Coalesce concurrent single-row score calls into padded batches
    through any row-wise ``fn`` (``numpy (B, ...) -> (B, ...)``; a
    ``forward_local`` over a model's params, for example).

    Rows queue through the same bounded :class:`RequestQueue` as
    generation; the worker pads each batch up to a power-of-two bucket by
    repeating the first row (pad outputs are discarded), so ``fn`` sees at
    most ``log2(max_batch) + 1`` shapes.  ``fn``'s outputs come back to
    the host once a batch.  Publishes to its own registry ``metrics``."""

    def __init__(self, fn: Callable, max_batch: int = 64,
                 max_queue: int = 256, max_batch_delay_ms: float = 2.0):
        self.fn = fn
        self.max_batch = max_batch
        self.metrics = MetricsRegistry()
        self._queue = RequestQueue(max_queue, max_batch_delay_ms,
                                   metrics=self.metrics)
        self._shape_lock = threading.Lock()
        self._row_shape: tuple | None = None  # guarded-by: self._shape_lock
        self._buckets: set[int] = set()       # serve-thread-owned
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "BatchScorer":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="serving-scorer")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._queue.wake()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        for p in self._queue.drain():
            p._fail(RuntimeError("scorer stopped before request ran"))

    def __enter__(self) -> "BatchScorer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def submit(self, x) -> PendingResult:
        x = np.asarray(x)
        # check-then-set is atomic: two first submitters racing here
        # could otherwise publish different shapes
        with self._shape_lock:
            if self._row_shape is None:
                self._row_shape = x.shape
            elif x.shape != self._row_shape:
                raise ValueError(
                    f"row shape {x.shape} != first-seen {self._row_shape}")
        return self._queue.submit(ScoreRequest(x=x))

    def score(self, x, timeout: float = 30.0):
        """One row in, one output row out (blocking)."""
        return self.submit(x).result(timeout)

    def score_batch(self, xs, timeout: float = 30.0) -> np.ndarray:
        """Submit every row, gather in order: rows of concurrent callers
        interleave into shared batches."""
        handles = [self.submit(x) for x in np.asarray(xs)]
        return np.stack([h.result(timeout) for h in handles])

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return min(b, self.max_batch)

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._queue.take(self.max_batch, block_s=0.05)
            if not batch:
                continue
            try:
                self._run(batch)
            except Exception as e:  # fail this batch, keep serving
                self.metrics.increment("serving.score.errors")
                for p in batch:
                    p._fail(e)

    def _run(self, batch: list[PendingResult]) -> None:
        n = len(batch)
        bucket = self._bucket(n)
        xs = np.stack([p.request.x for p in batch])
        if bucket > n:
            xs = np.concatenate(
                [xs, np.broadcast_to(xs[:1], (bucket - n,) + xs.shape[1:])])
        if bucket not in self._buckets:
            self._buckets.add(bucket)
            self.metrics.increment("serving.score.recompile")
        with self.metrics.time("serving.score_batch"), torch.no_grad():
            ys = self.fn(xs)
            ys = (ys.detach().cpu().numpy() if torch.is_tensor(ys)
                  else np.asarray(ys))
        self.metrics.observe_time("serving.score.batch_fill", n / bucket,
                                  buckets=FILL_BUCKETS)
        self.metrics.increment("serving.score.rows", n)
        for i, p in enumerate(batch):
            p._complete(ys[i])


__all__ = ["BatchScorer", "FILL_BUCKETS", "IMPL_ALIASES", "InferenceEngine",
           "ServingConfig", "kv_page_bytes"]
