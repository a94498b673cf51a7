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
back-to-back under :func:`~..analysis.runtime.hot_loop_guard` — no
``.item()``, ``.cpu()``, ``.tolist()`` or pageable upload; a host sync
there raises at its call site (opt out: ``DL4J_TPU_TRANSFER_GUARD=0``).
The emitted tokens stay on the device until ``_resolve`` pulls the whole
segment in ONE copy under an ``allow_transfers()`` fence, where
EOS/length bookkeeping, admissions and metrics happen; admission,
quantization, warmup, wipes, prefill, migration and reload are fences
too.  The steps dispatch through ``SHARDGUARD.wrap``
(``serving.decode_step``, and ``serving.decode_step_plain`` for a
speculative engine's plain step) in baseline mode.
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

The disaggregated tier's roles (``role="prefill"``: no serve thread,
:meth:`InferenceEngine.prefill` fills a request's KV pages and hands them
off as a :class:`PrefillRecord`; ``role="decode"``: a unified engine
that admits migrated requests through :meth:`admit_from_pages` between
decode segments).  A migrated request enters its slot with the pages
the migrator uploaded (byte for byte what the prefill engine's pool
stores: float, int8 or fp8 pages and their scales) and the same host
state a local admission writes, so it decodes token-identically.

Observability, as the reference's: the engine and its queue publish to
the process-wide ``METRICS``; every request carries a trace id (adopted
from the caller's context, e.g. an HTTP ``traceparent``, else minted) and
records ``serving.queue_wait``, ``serving.prefill``, one
``serving.decode.segment`` per resolve fence, ``serving.emit`` and its
root ``serving.request`` span; tenants are folded through ``TENANTS`` at
submission and accounted at completion; warmup counts the decode step's
and a prefill token's flops and bytes (``COSTS``, on fake tensors), and
each fence publishes ``serving.decode_mfu`` / ``serving.decode_mbu`` from
the step time it already measures (no host sync); a page-pool 429 notes
the flight recorder's burst trigger.  Chaos sites: ``serving.request``,
``serving.page_pool``, ``serving.decode`` and ``serving.draft``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Callable

import numpy as np
import torch

from ..analysis.runtime import allow_transfers, hot_loop_guard
from ..analysis.shardguard import SHARDGUARD
from ..device import resolve_device
from ..models.transformer import (cast_for_decode, decode_step,
                                  decode_step_paged, decode_window,
                                  decode_window_paged, gather_paged_layer,
                                  gumbel_noise, init_decode_cache,
                                  init_paged_cache, paged_flat_index,
                                  reset_cache_pages, reset_cache_slots,
                                  scatter_paged_layer, scatter_rows)
from ..observability import COSTS, FLIGHTREC, METRICS, TENANTS, trace
from ..observability.core import enabled as _obs_enabled
from ..observability.cost import CostInfo
from ..ops.cuda import build, kv_quant, registry
from ..parallel.checkpoint import CheckpointManager
from ..ops.cuda.matmul_int8 import quantize_params_for_decode
from ..resilience.faults import FAULTS
from .batcher import (Completion, GenerateRequest, PagePoolExhausted,
                      PendingResult, QueueFull, RequestQueue, ScoreRequest)
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
    kv_quant: str | None = None     # None = model dtype, "int8" / "fp8" =
    #                                 per-page per-head absmax int8 or
    #                                 float8_e4m3fn storage (needs paged)
    role: str = "unified"           # "unified", "prefill" (prefill only:
    #                                 no serve thread, work arrives through
    #                                 prefill() and leaves as KV pages;
    #                                 needs paged) or "decode" (a unified
    #                                 engine publishing the decode tier's
    #                                 queue gauge, the admit_from_pages
    #                                 target)


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


class MigrationRejected(RuntimeError):
    """A migrated request could not be admitted into the decode batch
    (the weight generation moved between claim and admission, or the
    engine stopped).  Nothing was corrupted: the decode side released
    its references, and the request can be requeued and migrated again
    (:class:`~.disagg.DisaggScheduler` does so)."""


@dataclasses.dataclass
class PrefillRecord:
    """The migration handoff unit :meth:`InferenceEngine.prefill` returns:
    the request's filled KV pages (block-table order, one reference per
    page owned by this record) and what the decode side needs to continue
    the request token-identically.  Exactly one of
    :meth:`InferenceEngine.release_prefill` or the migrator's export
    consumes it."""

    prompt: list[int]
    max_new_tokens: int
    temperature: float
    seed: int
    eos_id: int | None
    pages: list[int]        # block-table order; record owns one ref each
    cached_len: int         # positions aliased from the prefill-side cache
    generation: int         # prefill-engine weight generation of the pages


class MigrationTicket:
    """Accept/reject signal for one :meth:`InferenceEngine.admit_from_pages`
    handoff, resolved by the serve thread at its drain fence: accepted
    means the engine owns the pages and the request will decode (its
    completion arrives through the pending handle); rejected means the
    references were released and the caller should requeue."""

    def __init__(self):
        self._ev = threading.Event()
        self._accepted = False          # write-once before _ev.set()
        self._reason: str | None = None

    def _resolve(self, accepted: bool, reason: str | None = None) -> None:
        self._accepted = accepted
        self._reason = reason
        self._ev.set()

    def wait(self, timeout: float | None = None) -> bool:
        """True = admitted, False = rejected (see :attr:`reason`)."""
        if not self._ev.wait(timeout):
            raise TimeoutError("migration ticket unresolved — is the "
                               "decode engine's serve loop running?")
        return self._accepted

    @property
    def reason(self) -> str | None:
        return self._reason


@dataclasses.dataclass
class _MigratedIn:
    """One migrated request parked for the serve thread's drain fence.
    ``pages`` arrive with one reference each on THIS engine's pool (the
    migrator claimed and allocated them); the engine owns them from the
    moment the record enters ``_migrated_in``."""

    pending: PendingResult
    pages: list[int]                  # block-table order, decode-side ids
    uploads: list                     # [(page_id, [{name: tensor}, ...])]
    generation: int | None            # decode generation the claim assumed
    ticket: MigrationTicket


def _byte_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` along axis 0, gathered through the bytes (every dtype
    of a page pool, fp8 included, moves as the same uint8 rows)."""
    return arr.view(torch.uint8)[idx].view(arr.dtype)


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
    sharing the target's vocabulary and ``max_len``."""

    def __init__(self, model, params=None, checkpoint=None,
                 cfg: ServingConfig = ServingConfig(), draft_model=None,
                 draft_params=None, *, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        if cfg.prefix_cache and not cfg.paged:
            raise ValueError("prefix_cache requires paged=True (sharing is "
                             "block-table aliasing)")
        if cfg.role not in ("unified", "prefill", "decode"):
            raise ValueError(f"role must be unified/prefill/decode, "
                             f"got {cfg.role!r}")
        if cfg.role == "prefill" and not cfg.paged:
            raise ValueError("role='prefill' requires paged=True — the "
                             "migration unit is a KV page")
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
        # per-tier queue depth: prefill pressure and decode pressure under
        # their own gauge names; unified keeps the classic one
        self._queue = RequestQueue(
            cfg.max_queue, cfg.max_batch_delay_ms,
            depth_gauge={"prefill": "serving.queue.depth.prefill",
                         "decode": "serving.queue.depth.decode"}.get(
                             cfg.role, "serving.queue.depth"))
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
        # serializes prefill()/release_prefill()/read_pages(): on a
        # prefill-role engine (no serve thread) _state is owned by
        # whichever worker holds this lock
        self._prefill_lock = threading.Lock()
        # migrated requests parked for the serve thread's drain fence
        self._migrated_in: list[_MigratedIn] = []    # guarded-by: self._lock
        # shardguard baseline mode: the first decode dispatch captures the
        # params/state placements; a later dispatch arriving differently
        # placed (a reload onto another device) is counted.  One flag
        # check when off.  A speculative engine also carries the plain
        # step (the brownout fallback), under its own site
        self._step_fn = SHARDGUARD.wrap(
            "serving.decode_step",
            self._spec_step if cfg.speculative else self._step)
        self._plain_step_fn = (SHARDGUARD.wrap(
            "serving.decode_step_plain", self._step)
            if cfg.speculative else None)
        self._rows = torch.arange(cfg.slots, device=self.device)
        self._offsets = torch.arange(self._window, device=self.device,
                                     dtype=torch.int32)
        self._state = self._init_state()
        self._warmed = False
        # counted at warmup (COSTS): one decode dispatch, for the live
        # decode_mfu/mbu gauges, and one prompt token of a prefill, whose
        # multiples are each prefill bucket's cost
        self._decode_cost: CostInfo | None = None
        self._prefill_token_cost: CostInfo | None = None
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
        with allow_transfers(), METRICS.time("serving.quantize"), \
                torch.no_grad():
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
        gather path; any other name resolves a registry candidate (the
        quantized kind for int8 and fp8 pages alike).  A candidate whose
        kernel module failed to import raises, naming the import error:
        the engine never takes the plain version in its place."""
        impl = self.cfg.paged_attention_impl
        if impl == "gather":
            return None
        kind = ("paged_attention_int8" if self.cfg.kv_quant is not None
                else "paged_attention")
        try:
            return registry.get(kind, IMPL_ALIASES.get(impl, impl)).fn
        except KeyError as e:
            raise RuntimeError(
                f"paged_attention_impl={impl!r}: {e.args[0]}; kernel "
                "modules that failed to import: "
                f"{registry.import_errors() or 'none'}") from None

    def _picks(self, logits, sampled, st) -> torch.Tensor:
        """Token picks (S, W) int32 from the logits (S, W, V) of a step:
        the argmax, except for the ``sampled`` slots ``(slot,
        temperature)``, whose window position w reads the noise row of
        generated token ``pos - gbase + w`` (drawn ahead by
        :meth:`_plan_step`): ``sample_token``'s arithmetic on its
        draw."""
        pick = torch.argmax(logits, dim=-1).to(torch.int32)
        W = logits.shape[1]
        for s, temp in sampled:
            g = (st["pos"][s] - st["gbase"][s]) + self._offsets[:W]
            noise = st["noise"][s, (g % self._ring).long()]      # (W, V)
            pick[s] = torch.argmax(logits[s].float() / temp - noise,
                                   dim=-1).to(torch.int32)
        return pick

    def _step(self, params, sampled, st) -> torch.Tensor:
        """Advance every occupied slot of the device state ``st`` one
        token; returns the emitted ids (S,) int32 on the device, -1 for
        rows that did not generate.

        Inactive / exhausted rows still flow through the batched matmuls
        (masked no-ops), but their positions and token buffers are frozen.
        ``sampled`` lists the sampled slots (:meth:`_picks`)."""
        mcfg = self.model.cfg
        pos, active, limit, toks = (st["pos"], st["active"], st["limit"],
                                    st["toks"])
        rows = self._rows
        cur = toks[rows, pos.long()]
        if self.cfg.paged:
            logits, _ = decode_step_paged(params, st["pages"], st["bt"], cur,
                                          pos, mcfg, attn_fn=self._attn_fn)
        else:
            logits, _ = decode_step(params, st["cache"], cur, pos, mcfg)
        pick = self._picks(logits[:, None], sampled, st)[:, 0]
        can = active & (pos < limit) & (pos + 1 < mcfg.max_len)
        emitted = torch.where(can, pick, torch.full_like(pick, -1))
        new_pos = torch.where(can, pos + 1, pos)
        idx = new_pos.long()
        toks[rows, idx] = torch.where(can, pick, toks[rows, idx])
        pos.copy_(new_pos)
        return emitted

    def _spec_step(self, params, sampled, st,
                   garble: bool = False) -> torch.Tensor:
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
        draft decides how many tokens emit, never which: ``garble`` (the
        ``serving.draft`` chaos site) shifts every proposal by one, which
        shortens the accepted runs and leaves the emitted tokens as they
        are."""
        mcfg = self.model.cfg
        T = mcfg.max_len
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
            if garble:
                inp = (inp + 1) % mcfg.vocab_size
            proposals.append(inp)
        d = torch.stack(proposals, dim=1)                       # (S, k)
        window = torch.cat([cur[:, None], d], dim=1)            # (S, W)
        if self.cfg.paged:
            logits, _ = decode_window_paged(params, st["pages"], st["bt"],
                                            window, pos, mcfg)
        else:
            logits, _ = decode_window(params, st["cache"], window, pos, mcfg)
        picks = self._picks(logits, sampled, st)                # (S, W)
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
        for int8 and fp8 pages: their scales are monotone).  A
        speculative engine prefills the draft's dense row beside the
        target (:meth:`_arm_slot`)."""
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
        for i in range(cached_len, p_len - 1):
            decode_step(params, cache1, prompt[i:i + 1], i, mcfg)
        if self.cfg.paged:
            t = torch.arange(mcfg.max_len, device=self.device)[None, :]
            flat = paged_flat_index(bt_row, t, self._page_size)[0]
            for c, c1 in zip(st["pages"], cache1):
                scatter_paged_layer(c, flat, c1["k"][0], c1["v"][0])
        else:
            for c, c1 in zip(st["cache"], cache1):
                c["k"][slot] = c1["k"][0]
                c["v"][slot] = c1["v"][0]
        self._arm_slot(slot, req, prompt)

    def _arm_slot(self, slot: int, req: GenerateRequest,
                  prompt: torch.Tensor) -> None:
        """The rest of an admission once the slot's K/V holds
        ``prompt[:-1]``: a speculative engine's draft row, the token
        buffer and the row's positions."""
        st = self._state
        p_len = len(req.prompt)
        if self.cfg.speculative:
            # the draft's dense row, always from position 0 (prefix
            # aliasing and migration carry target pages only)
            dcfg = self._draft_model.cfg
            dcache1 = init_decode_cache(dcfg, 1, self.device)
            for i in range(p_len - 1):
                decode_step(self._draft_params, dcache1, prompt[i:i + 1], i,
                            dcfg)
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
        ``tenant`` is an opaque caller identity, folded once here through
        the bounded ``TENANTS`` labels; the label rides the request.
        ``priority`` > 0 marks background work, claimed only while no
        interactive request waits.  A brownout cap
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
            METRICS.increment("serving.max_new_clamped")
        req = GenerateRequest(
            prompt=prompt, max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), seed=int(seed),
            eos_id=eos_id if eos_id is not None else self.cfg.default_eos_id,
            deadline_s=(time.monotonic() + deadline_ms / 1000.0
                        if deadline_ms else None),
            tenant=TENANTS.label(str(tenant)) if tenant else "",
            priority=1 if int(priority) > 0 else 0)
        if hook is not None:
            hook(req)
        if _obs_enabled():
            # one trace id for the whole request: the caller's context
            # (an HTTP traceparent bound by the server, or an enclosing
            # span), else a fresh one
            ctx = trace.current_trace_context()
            if ctx is not None:
                req.trace_id, req.parent_span_id = ctx
            else:
                req.trace_id = trace.new_trace_id()
            req.root_span_id = trace.new_span_id()
        METRICS.increment("serving.requests")
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
        if self.cfg.role == "prefill":
            # no decode loop: work arrives through prefill() on the
            # scheduler's workers, and _state stays owned by whoever
            # holds _prefill_lock
            return self
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
            pending, self._pending_wipe = self._pending_wipe, []
            migrated, self._migrated_in = self._migrated_in, []
        for sl in dead.values():
            sl.pending._fail(
                RuntimeError("engine stopped with request in flight"))
        for rec in migrated:
            # reject, never corrupt: the pages are released below and the
            # scheduler requeues on MigrationRejected
            rec.ticket._resolve(False, "engine stopped")
            rec.pending._fail(MigrationRejected(
                "engine stopped before migrated request was admitted"))
        # the serve thread is joined, so _state is safe to touch: reset the
        # dead rows the way _evict would have, and wipe what the pending
        # lists held before their pages become allocatable
        with torch.no_grad():
            for s in dead:
                self._release_row(s, pages.get(s, []))
            for rec in migrated:
                self._wipe_pages(self._pool.decref(rec.pages))
            if pending:
                self._wipe_pages(pending)
                self._pool.requeue(pending)
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
        no build or first-launch cost.  Before that, count the flops and
        bytes of one decode dispatch and of one prompt token of a prefill
        (``COSTS``, on fake copies of the state: nothing runs, nothing
        changes)."""
        with allow_transfers(), METRICS.time("serving.warmup"), \
                torch.no_grad():
            if self.device.type == "cuda":
                build.build_all()
            with self._lock:
                params = self._params
            if self.cfg.role == "prefill":
                # a prefill-role engine never runs the decode step
                self._warmed = True
                return
            if _obs_enabled():
                self._capture_costs(params)
            self._step_fn(params, [], self._state).cpu()
            if self.cfg.speculative:
                self._plain_step_fn(params, [], self._state).cpu()
        self._warmed = True

    def _capture_costs(self, params) -> None:
        mcfg = self.model.cfg
        step = self._spec_step if self.cfg.speculative else self._step
        self._decode_cost = COSTS.capture(
            "serving.decode_step", lambda p, st: step(p, [], st), params,
            self._state)
        caches = [init_decode_cache(mcfg, 1, self.device)]
        if self.cfg.speculative:
            caches.append(init_decode_cache(self._draft_model.cfg, 1,
                                            self.device))
        tok = torch.zeros((1,), dtype=torch.long, device=self.device)
        self._prefill_token_cost = COSTS.capture(
            "serving.prefill_token", self._prefill_token, params, caches,
            tok)

    def _prefill_token(self, params, caches, tok) -> None:
        """One prompt token of a prefill on batch-of-1 caches (the target's
        and a speculative engine's draft's): the unit of the prefill cost
        count.  A dense decode step attends over every position under a
        mask, so each prompt token costs the same."""
        decode_step(params, caches[0], tok, 0, self.model.cfg)
        if self.cfg.speculative:
            decode_step(self._draft_params, caches[1], tok, 0,
                        self._draft_model.cfg)

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
        with allow_transfers():   # the page list's upload: a fence
            mask[torch.tensor(freed, device=self.device)] = True
        reset_cache_pages(self._state["pages"], mask)

    def _serve_loop(self) -> None:
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    self._serve_once()
                except Exception as e:  # a wedged loop strands callers
                    METRICS.increment("serving.engine.errors")
                    with self._lock:
                        self._last_error = traceback.format_exc()
                        dead = [self._slots.pop(s) for s in list(self._slots)]
                        self._slot_pages.clear()
                        self._free = list(range(self.cfg.slots))
                        migrated, self._migrated_in = self._migrated_in, []
                    for sl in dead:
                        sl.pending._fail(e)
                    for rec in migrated:
                        # pool.reset() below reclaims their pages
                        rec.ticket._resolve(False, "serve loop crashed")
                        rec.pending._fail(MigrationRejected(
                            "serve loop crashed before admission"))
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
        if not staged:
            # migrated requests enter the continuous batch here, between
            # decode segments
            self._drain_migrated()
        idle = not self._slots
        n_free = len(self._free)
        if n_free and not staged:
            # admission pauses while a swap is staged: in-flight slots
            # drain, the fence arrives, and queued requests then decode
            # wholly under the NEW generation
            batch = self._queue.take(
                n_free, block_s=self.cfg.idle_wait_s if idle else 0.0)
            if batch:
                # admission is a deliberate host<->device seam (prompt
                # upload, block-table rows) — annotated, off the
                # per-token path
                with allow_transfers(), trace.span("serving.admit"):
                    self._admit(batch)
        if not self._slots:
            return
        METRICS.observe_time("serving.batch_fill_ratio",
                             len(self._slots) / self.cfg.slots,
                             buckets=FILL_BUCKETS)
        t0 = time.perf_counter()
        with hot_loop_guard():
            pending = self._decode_segment()
        with allow_transfers(), trace.span("serving.resolve"):
            self._resolve(pending, t0)

    def _admit(self, batch: list[PendingResult]) -> None:
        for p in batch:
            if not self._queue.claim(p):
                continue
            req: GenerateRequest = p.request
            if req.trace_id:
                t_claim = time.perf_counter()
                trace.record_span(
                    "serving.queue_wait", req.submitted_perf,
                    t_claim - req.submitted_perf, trace_id=req.trace_id,
                    parent_id=req.root_span_id, request=req.id)
            bucket = self._prompt_bucket(len(req.prompt))
            with self._lock:
                slot = self._free.pop()
                params = self._params
                # the generation stamp is atomic with the params capture
                gen_id, lstep = self._generation, self._loaded_step
                new_bucket = bucket not in self._buckets
                self._buckets.add(bucket)
            if new_bucket and self._prefill_token_cost is not None:
                # a bucket's prefill: bucket - 1 prompt tokens, counted
                c = self._prefill_token_cost
                COSTS.put(f"serving.prefill.b{bucket}", CostInfo(
                    c.flops * (bucket - 1), c.bytes_accessed * (bucket - 1),
                    c.source))
            acquired: list[int] = []
            try:
                cached_len = 0
                usable = len(req.prompt) - 1
                if self.cfg.paged:
                    if FAULTS.check("serving.page_pool") is not None:
                        raise PagePoolExhausted(
                            "injected page-pool exhaustion (chaos site "
                            "serving.page_pool)")
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
                            # released by the handler's _release_row
                            shared, cached_len = self._pool.lookup_prefix(  # graftlint: disable=PG01
                                req.prompt, usable)
                        acquired.extend(shared)
                    # allocate for what THIS request can touch (positions
                    # [0, limit]); the row's tail parks on the trash page
                    need = -(-(len(req.prompt) + req.max_new_tokens)
                             // self._page_size)
                    # released by the handler's _release_row
                    acquired.extend(self._pool.alloc(need - len(acquired)))  # graftlint: disable=PG01
                    row = acquired + [self._num_pages] * (
                        self._pages_per_slot - len(acquired))
                    self._state["bt"][slot] = torch.tensor(
                        row, dtype=torch.int32)
                    # the slot holds its pages from here: the prefill
                    # below runs token by token from the host (the
                    # reference's is one asynchronous dispatch), so the
                    # footprint gauges count it before, not after
                    self._publish_kv_gauges(admitting=acquired)
                t_pre = time.perf_counter()
                self._prefill(params, slot, req, cached_len)
                t_done = time.perf_counter()
                METRICS.observe_time("serving.prefill", t_done - t_pre)
                if req.trace_id:
                    trace.record_span(
                        "serving.prefill", t_pre, t_done - t_pre,
                        trace_id=req.trace_id, parent_id=req.root_span_id,
                        request=req.id, bucket=bucket)
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
                        METRICS.increment("serving.prefix_hits")
                        # prompt positions whose prefill the cache saved
                        METRICS.increment("serving.prefix_cached_tokens",
                                          cached_len)
            except Exception as e:
                # fail only THIS request; the slot and its pages go back
                # (an aliased page keeps its other readers' references)
                self._release_row(slot, acquired)
                with self._lock:
                    self._free.append(slot)
                if isinstance(e, PagePoolExhausted):
                    METRICS.increment("serving.page_pool_exhausted")
                    FLIGHTREC.note_429()
                else:
                    METRICS.increment("serving.engine.errors")
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
            METRICS.increment("serving.admitted")
            self._publish_kv_gauges()

    def _publish_kv_gauges(self, admitting: list[int] | None = None) -> None:
        """Device-KV footprint gauges at admission/eviction fences;
        ``admitting``: the pages of a slot whose prefill is about to run,
        counted as one more occupied slot."""
        mcfg = self.model.cfg
        m = METRICS
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
            occupied = len(self._slots) + (admitting is not None)
            slot_pages = {p for pages in self._slot_pages.values()
                          for p in pages}
        slot_pages.update(admitting or ())
        m.gauge("serving.kv_pages_in_use", in_use)
        m.gauge("serving.kv_pages_total", self._num_pages)
        m.gauge("serving.kv_page_bytes", self._page_bytes)
        m.gauge("serving.prefix_hit_rate", self._pool.hit_rate())
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
        (:meth:`set_speculative`) turned it off, read once a segment.  A
        ``serving.decode`` fault skips one dispatch (the next retries it);
        ``serving.draft`` garbles a dispatch's proposals."""
        with self._lock:
            params = self._params
            spec = self.cfg.speculative and self._spec_enabled
        out = []
        st = self._state
        for j in range(self.cfg.resolve_every):
            if FAULTS.check("serving.decode") is not None:
                METRICS.increment("serving.decode.faults")
                continue
            if spec:
                garbled = FAULTS.check("serving.draft") is not None
                if garbled:
                    METRICS.increment("serving.draft.faults")
                out.append(self._step_fn(
                    params, self._plan_step(self._window, j), st, garbled))
            else:
                step = self._plain_step_fn or self._step_fn
                out.append(step(params, self._plan_step(1, j), st)[:, None])
        METRICS.increment("serving.decode.dispatches", len(out))
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
        METRICS.observe_many("serving.decode_step",
                             [seg_s / n_steps] * n_steps)
        if self._decode_cost is not None:
            # live utilization: one dispatch's counted work over the
            # measured per-step time of this segment
            COSTS.publish_utilization(
                self._decode_cost, seg_s / n_steps,
                "serving.decode_mfu", "serving.decode_mbu")
        if self.cfg.speculative:
            # tokens emitted per dispatch per live slot (clipped emissions
            # at the limit count too)
            counts = (em >= 0).sum(axis=2)
            METRICS.observe_many(
                "serving.spec_accept_len",
                [float(c) for c in counts[counts > 0]],
                buckets=tuple(float(i)
                              for i in range(1, self.cfg.spec_k + 2)))
        delivered = 0
        for s in list(self._slots):
            sl = self._slots[s]
            req: GenerateRequest = sl.pending.request
            if req.trace_id:
                # one span per live slot per segment: the slots share the
                # segment's wall clock
                trace.record_span(
                    "serving.decode.segment", t0, seg_s,
                    trace_id=req.trace_id, parent_id=req.root_span_id,
                    request=req.id, slot=s, steps=n_steps)
            finish = None
            for t in em[:, s].reshape(-1):
                t = int(t)
                if t < 0:
                    continue
                delivered += 1
                if sl.first_token_s is None:
                    sl.first_token_s = now  # fence granularity
                    METRICS.observe_time("serving.ttft",
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
            METRICS.increment("serving.tokens", delivered)
            if seg_s > 0:
                METRICS.gauge("serving.tokens_per_sec", delivered / seg_s)

    def _evict(self, s: int, finish: str, now: float) -> None:
        """Free slot ``s``: release its row, complete the caller, account
        its tenant and record its emit and root spans."""
        t_ev = time.perf_counter()
        with self._lock:
            sl = self._slots.pop(s)
            pages = self._slot_pages.pop(s, [])
            self._free.append(s)
            self._completed += 1
        self._release_row(s, pages)
        if self.cfg.paged:
            self._publish_kv_gauges()
        req = sl.pending.request
        METRICS.increment("serving.completed")
        METRICS.observe_time("serving.request_latency", now - req.submitted_s)
        if req.tenant:
            TENANTS.account("prompt_tokens", req.tenant, len(req.prompt))
            TENANTS.account("generated_tokens", req.tenant,
                            len(sl.delivered))
        sl.pending._complete(Completion(
            tokens=list(sl.delivered), finish_reason=finish,
            latency_s=now - req.submitted_s,
            ttft_s=(sl.first_token_s - req.submitted_s
                    if sl.first_token_s is not None else None),
            generation=sl.generation, loaded_step=sl.loaded_step))
        if req.trace_id:
            t_done = time.perf_counter()
            trace.record_span(
                "serving.emit", t_ev, t_done - t_ev, trace_id=req.trace_id,
                parent_id=req.root_span_id, request=req.id, finish=finish)
            # the root span, submit to completion, parented to the
            # inbound traceparent (if any)
            trace.record_span(
                "serving.request", req.submitted_perf,
                t_done - req.submitted_perf, trace_id=req.trace_id,
                parent_id=req.parent_span_id or None,
                span_id=req.root_span_id, request=req.id,
                tokens=len(sl.delivered), finish=finish,
                tenant=req.tenant or None)

    # ------------------------------------------------ disaggregated tier
    @property
    def page_pool(self) -> PagePool | None:
        """The host-side page pool (None on dense engines).  The decode
        half of a migration claims and allocates against it, through the
        migrator's export and import seams only."""
        return self._pool

    def prefill(self, prompt, max_new_tokens: int, temperature: float = 0.0,
                seed: int = 0, eos_id: int | None = None) -> PrefillRecord:
        """Prefill only, the prefill tier's whole job: fill the request's
        KV pages through the same :meth:`_prefill` a local admission runs
        (the numerics cannot diverge), then release the slot without
        decoding a token.  Returns a :class:`PrefillRecord` owning one
        reference per page.

        Needs a paged engine with no serve thread (a ``role='prefill'``
        engine never starts one): ``_state`` belongs to whichever worker
        holds ``_prefill_lock``."""
        if not self.cfg.paged:
            raise ValueError("prefill-only requires paged=True — the "
                             "migration unit is a KV page")
        if self._thread is not None:
            raise RuntimeError("prefill() needs exclusive ownership of the "
                               "device state — stop the serve loop first "
                               "(role='prefill' engines never start one)")
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
        req = GenerateRequest(prompt=prompt,
                              max_new_tokens=int(max_new_tokens),
                              temperature=float(temperature), seed=int(seed),
                              eos_id=(eos_id if eos_id is not None
                                      else self.cfg.default_eos_id))
        with self._prefill_lock, allow_transfers(), torch.no_grad(), \
                METRICS.time("serving.prefill_only"):
            with self._lock:
                # no serve loop reaches an all-slots-free fence here:
                # prefill entry is that fence
                applied = self._try_apply_staged_locked()
            if applied:
                self._publish_generation_gauges()
            self._drain_pending_wipe()
            with self._lock:
                if not self._free:
                    raise QueueFull("no free slot for prefill")
                slot = self._free.pop()
                params = self._params
                gen = self._generation
            acquired: list[int] = []
            try:
                cached_len = 0
                usable = len(prompt) - 1
                if self.cfg.prefix_cache:
                    # atomic with a params re-capture, as in _admit
                    with self._lock:
                        params = self._params
                        gen = self._generation
                        # released by the handler's _release_row
                        shared, cached_len = self._pool.lookup_prefix(  # graftlint: disable=PG01
                            prompt, usable)
                    acquired.extend(shared)
                need = -(-(len(prompt) + max_new_tokens) // self._page_size)
                # released by the handler's _release_row
                acquired.extend(self._pool.alloc(need - len(acquired)))  # graftlint: disable=PG01
                self._state["bt"][slot] = torch.tensor(
                    acquired + [self._num_pages] * (
                        self._pages_per_slot - len(acquired)),
                    dtype=torch.int32)
                self._prefill(params, slot, req, cached_len)
                if self.cfg.prefix_cache:
                    with self._lock:
                        if self._params is params:
                            self._pool.insert_prefix(prompt, acquired,
                                                     usable)
                    if cached_len:
                        METRICS.increment("serving.prefix_hits")
            except Exception:
                self._release_row(slot, acquired)
                with self._lock:
                    self._free.append(slot)
                raise
            # release the slot without decoding: the pages stay pinned by
            # the record's references, and the record is what migrates
            self._state["active"][slot] = False
            self._state["bt"][slot] = self._num_pages
            with self._lock:
                self._free.append(slot)
            METRICS.increment("serving.prefills")
            return PrefillRecord(
                prompt=prompt, max_new_tokens=req.max_new_tokens,
                temperature=req.temperature, seed=req.seed,
                eos_id=req.eos_id, pages=acquired, cached_len=cached_len,
                generation=gen)

    def release_prefill(self, record: PrefillRecord) -> None:
        """Consume a :class:`PrefillRecord` without migrating it (abort,
        a killed worker): release its pages and wipe those that died.
        Safe only where :meth:`prefill` is (no serve thread)."""
        if not record.pages:
            return
        with self._prefill_lock, allow_transfers(), torch.no_grad():
            pages, record.pages = record.pages, []
            self._wipe_pages(self._pool.decref(pages))

    def read_pages(self, ids) -> list[dict]:
        """Host copies of the given physical pages: one dict a layer from
        the pool's names (``k``/``v``, and ``k_scale``/``v_scale`` under
        kv_quant) to an ``(n, ...)`` CPU tensor of the pool's dtype.  The
        rows move as bytes, so whatever the pool stores (float, int8 or
        fp8 pages, GQA layouts) is what a migration moves."""
        if not self.cfg.paged:
            raise ValueError("read_pages needs a paged engine")
        with self._prefill_lock, allow_transfers(), torch.no_grad():
            idx = torch.tensor(list(ids), dtype=torch.long,
                               device=self.device)
            return [{name: _byte_rows(arr, idx).cpu()
                     for name, arr in layer.items()}
                    for layer in self._state["pages"]]

    def queue_wipe(self, pages: list[int]) -> None:
        """Hand quarantined pages (no references left, off the free list)
        to the serve thread, which wipes them before they are allocatable
        again: the migrator never touches device state it does not own."""
        if not pages:
            return
        with self._lock:
            self._pending_wipe.extend(pages)
        self._queue.wake()

    def admit_from_pages(self, pending: PendingResult, *, pages: list[int],
                         uploads: list,
                         generation: int | None = None) -> MigrationTicket:
        """Queue a migrated request for admission into the continuous
        batch; the serve thread installs it between decode segments
        (:meth:`_drain_migrated`).

        ``pages`` (block-table order) hold one reference each on THIS
        engine's pool, and the engine owns them from here on: whatever
        happens next (admission, a generation-mismatch reject, stop, a
        crash) it releases them exactly once.  ``uploads`` carries bytes
        only for the pages that moved; claimed pages are resident.
        Returns a :class:`MigrationTicket` resolved at the drain fence."""
        if not self.cfg.paged:
            raise ValueError("admit_from_pages needs a paged engine")
        if self.cfg.role == "prefill":
            raise ValueError("a prefill-role engine cannot decode")
        req: GenerateRequest = pending.request
        need = -(-(len(req.prompt) + req.max_new_tokens) // self._page_size)
        if len(pages) != need or need > self._pages_per_slot:
            raise ValueError(
                f"page count {len(pages)} does not cover prompt+budget "
                f"(need {need}, pages_per_slot {self._pages_per_slot})")
        ticket = MigrationTicket()
        with self._lock:
            self._migrated_in.append(_MigratedIn(
                pending=pending, pages=list(pages), uploads=list(uploads),
                generation=generation, ticket=ticket))
        self._queue.wake()   # break the serve loop's idle wait
        return ticket

    def _drain_migrated(self) -> None:
        """Serve-thread drain of :meth:`admit_from_pages` records, one free
        slot each.  A record whose claim generation no longer matches (a
        reload applied since the migrator planned it) is rejected, its
        pages released: its claimed pages hold old-weight K/V, and the
        scheduler migrates it again under the new weights."""
        while True:
            with self._lock:
                if not self._migrated_in or not self._free \
                        or self._staged is not None:
                    return
                rec = self._migrated_in.pop(0)
                slot = self._free.pop()
                gen_id, lstep = self._generation, self._loaded_step
            with allow_transfers(), trace.span("serving.admit_migrated"):
                ok = (rec.generation is None or rec.generation == gen_id) \
                    and not rec.pending.done()
                if not ok:
                    # reject, do not fail: the handle stays open for the
                    # migrator to hand the same request back
                    self._wipe_pages(self._pool.decref(rec.pages))
                    with self._lock:
                        self._free.append(slot)
                    rec.ticket._resolve(
                        False, "request done" if rec.pending.done()
                        else "weight generation moved since migration plan")
                    continue
                try:
                    self._admit_migrated(rec, slot)
                except Exception as e:
                    self._release_row(slot, rec.pages)
                    with self._lock:
                        self._free.append(slot)
                    rec.ticket._resolve(False, str(e))
                    rec.pending._fail(e)
                    METRICS.increment("serving.engine.errors")
                    continue
                req: GenerateRequest = rec.pending.request
                gen = None
                if req.temperature > 0:
                    gen = torch.Generator(
                        device=self.device).manual_seed(req.seed)
                with self._lock:
                    self._slots[slot] = _Slot(
                        pending=rec.pending, admitted_s=time.monotonic(),
                        gen=gen, generation=gen_id, loaded_step=lstep)
                    self._slot_pages[slot] = rec.pages
                    self._admitted += 1
                rec.ticket._resolve(True)
                METRICS.increment("serving.admitted")
                self._publish_kv_gauges()

    def _admit_migrated(self, rec: _MigratedIn, slot: int) -> None:
        """Install a migrated request into ``slot``: write the moved page
        bytes (claimed pages are resident already), point the block-table
        row at the pages and arm the row as a local admission would, with
        no prefill of the target (skipping it is migration's gain).  A
        speculative engine rebuilds the row's draft cache, at the draft's
        cost (:meth:`_arm_slot`); the draft decides how many tokens emit,
        never which."""
        req: GenerateRequest = rec.pending.request
        st = self._state
        if rec.uploads:
            ids = torch.tensor([pid for pid, _ in rec.uploads],
                               dtype=torch.long, device=self.device)
            for li, layer in enumerate(st["pages"]):
                for name, arr in layer.items():
                    vals = torch.stack([u[1][li][name] for u in rec.uploads])
                    if vals.shape[1:] != arr.shape[1:]:
                        raise ValueError(
                            f"migrated {name} pages {tuple(vals.shape[1:])}"
                            f" do not fit the pool's {tuple(arr.shape[1:])}")
                    # byte for byte: the pool stores what the exporter's
                    # pool stored (float, int8 or fp8 and its scales)
                    arr.view(torch.uint8)[ids] = vals.to(arr.dtype).view(
                        torch.uint8).to(self.device)
        st["bt"][slot] = torch.tensor(
            rec.pages + [self._num_pages] * (
                self._pages_per_slot - len(rec.pages)), dtype=torch.int32)
        prompt = torch.tensor(req.prompt, dtype=torch.long,
                              device=self.device)
        self._arm_slot(slot, req, prompt)
        if self.cfg.prefix_cache:
            # publish the migrated prompt's chains on THIS pool: the next
            # migration of the prefix is a hash-only claim.  The
            # generation matched at the drain fence, and no swap applies
            # while this slot is out of _free
            with self._lock:
                self._pool.insert_prefix(req.prompt, rec.pages,
                                         len(req.prompt) - 1)

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
        with allow_transfers(), METRICS.time("serving.reload"), \
                torch.no_grad():
            restored = self._ckpt.restore(template, step=target)
            new_params = self._maybe_quantize(restored["params"])
        with self._lock:
            self._staged = (restored["params"], new_params, target)
            applied = self._try_apply_staged_locked()
        METRICS.increment("serving.reloads")
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
        METRICS.gauge("serving.generation", gen)
        if step is not None:
            METRICS.gauge("serving.loaded_step", step)

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
        METRICS.gauge("serving.speculative_enabled", 1.0 if now else 0.0)
        return now

    def set_max_new_cap(self, cap: int | None) -> None:
        """Clamp every future request's ``max_new_tokens`` to ``cap`` at
        submission (``None`` lifts the clamp); admitted requests keep
        their budget."""
        if cap is not None and int(cap) < 1:
            raise ValueError(f"max_new cap must be >= 1, got {cap}")
        with self._lock:
            self._max_new_cap = int(cap) if cap is not None else None
        METRICS.gauge("serving.max_new_cap",
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
    the host once a batch.  Publishes to the process-wide ``METRICS``."""

    def __init__(self, fn: Callable, max_batch: int = 64,
                 max_queue: int = 256, max_batch_delay_ms: float = 2.0):
        self.fn = fn
        self.max_batch = max_batch
        self._queue = RequestQueue(max_queue, max_batch_delay_ms)
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
                METRICS.increment("serving.score.errors")
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
            METRICS.increment("serving.score.recompile")
        with METRICS.time("serving.score_batch"), torch.no_grad():
            ys = self.fn(xs)
            ys = (ys.detach().cpu().numpy() if torch.is_tensor(ys)
                  else np.asarray(ys))
        METRICS.observe_time("serving.score.batch_fill", n / bucket,
                                  buckets=FILL_BUCKETS)
        METRICS.increment("serving.score.rows", n)
        for i, p in enumerate(batch):
            p._complete(ys[i])


__all__ = ["BatchScorer", "FILL_BUCKETS", "IMPL_ALIASES", "InferenceEngine",
           "MigrationRejected", "MigrationTicket", "PrefillRecord",
           "ServingConfig", "kv_page_bytes"]
