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
per-request ``torch.Generator`` seeded with the request's ``seed`` through
:func:`~..models.transformer.sample_token`, once per generated token, so
they equal the offline sampler with the same seed.  The host knows
without a sync which slots generate at each step (``generated <
max_new_tokens``), so each generator advances exactly once per token.

Prefill runs the prompt token by token through the same ``decode_step``
as the offline sampler; the power-of-two prompt bucket ladder of the JAX
package (one compiled prefill per bucket) is kept only as bookkeeping
(``stats()["prefill_buckets"]``).

Not ported yet: ``speculative``, ``prefix_cache``, ``role != "unified"``
(they raise ``NotImplementedError``), hot reload from checkpoints,
tracing, the flight recorder, chaos sites and brownout actuators.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback

import torch

from ..device import resolve_device
from ..models.transformer import (cast_for_decode, decode_step,
                                  decode_step_paged, gather_paged_layer,
                                  init_decode_cache, init_paged_cache,
                                  paged_flat_index, reset_cache_pages,
                                  reset_cache_slots, sample_token,
                                  scatter_paged_layer)
from ..observability.metrics import MetricsRegistry
from ..ops.cuda import build, kv_quant, registry
from ..ops.cuda.matmul_int8 import quantize_params_for_decode
from .batcher import (Completion, GenerateRequest, PagePoolExhausted,
                      PendingResult, RequestQueue)
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
    prefix_cache: bool = False      # not ported yet (raises)
    speculative: bool = False       # not ported yet (raises)
    spec_k: int = 3
    paged_attention_impl: str = "gather"  # "gather" (plain torch) or a
    #                                 registry candidate: "cuda" /
    #                                 "cuda_int8" (aliases "pallas" /
    #                                 "pallas_int8")
    kv_quant: str | None = None     # None = model dtype, "int8" = per-page
    #                                 per-head absmax int8 (needs paged)
    role: str = "unified"           # only "unified" is ported


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
    generated: int = 0             # decode steps this slot generated in
    gen: torch.Generator | None = None   # sampled requests only


class InferenceEngine:
    """Continuous-batching decode over a ``TransformerLM``'s parameters.

    The JAX package's parameter order: ``params`` must already live on
    ``device`` (default ``cuda``, which raises when there is no GPU);
    restoring them from a ``checkpoint`` is not ported yet (ROADMAP.md
    A6) and raises.  ``registry`` is the metrics registry the engine
    publishes to (a fresh one by default; ``ModelServer`` serves it)."""

    def __init__(self, model, params=None, checkpoint=None,
                 cfg: ServingConfig = ServingConfig(), *, device=None,
                 registry: MetricsRegistry | None = None):
        if checkpoint is not None:
            raise NotImplementedError(
                "InferenceEngine(checkpoint=...): restoring params from a "
                "checkpoint is not ported to deeplearning4j_tpu_torch yet "
                "(ROADMAP.md A6); pass params")
        if params is None:
            raise ValueError("InferenceEngine needs params")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.metrics = registry if registry is not None else MetricsRegistry()
        if cfg.speculative or cfg.prefix_cache or cfg.role != "unified":
            raise NotImplementedError(
                "speculative decoding, the prefix cache and the "
                "prefill/decode roles are not ported to "
                "deeplearning4j_tpu_torch yet")
        if cfg.kv_quant is not None:
            if not cfg.paged:
                raise ValueError("kv_quant requires paged=True (scales live "
                                 "beside the page pool)")
            kv_quant.storage_dtype(cfg.kv_quant)  # validates the mode
        mcfg = model.cfg
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
        self._params = self._maybe_quantize(params)  # guarded-by: self._lock
        self._rows = torch.arange(cfg.slots, device=self.device)
        self._state = self._init_state()
        self._warmed = False
        self._buckets: set[int] = set()              # guarded-by: self._lock
        self._slots: dict[int, _Slot] = {}           # guarded-by: self._lock
        self._slot_pages: dict[int, list[int]] = {}  # guarded-by: self._lock
        self._free: list[int] = list(range(cfg.slots))  # guarded-by: self._lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._admitted = 0                           # guarded-by: self._lock
        self._completed = 0                          # guarded-by: self._lock
        self._last_error: str | None = None          # guarded-by: self._lock

    def _maybe_quantize(self, params):
        """The serving tree decode reads: with ``int8_decode`` the FFN
        w1/w2 and the LM head become int8 + per-channel scales; matmul
        operands are cast to the compute dtype once
        (:func:`~..models.transformer.cast_for_decode`)."""
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

    def _step(self, params, draws) -> torch.Tensor:
        """Advance every occupied slot one token; returns the emitted ids
        (S,) int32 on the device, -1 for rows that did not generate.

        Inactive / exhausted rows still flow through the batched matmuls
        (masked no-ops), but their positions and token buffers are frozen.
        ``draws`` lists ``(slot, temperature, generator)`` for the sampled
        slots that generate in this step."""
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
        pick = torch.argmax(logits, dim=-1).to(torch.int32)
        for s, temp, gen in draws:
            pick[s] = sample_token(logits[s], temp, gen)
        can = active & (pos < limit) & (pos + 1 < mcfg.max_len)
        emitted = torch.where(can, pick, torch.full_like(pick, -1))
        new_pos = torch.where(can, pos + 1, pos)
        idx = new_pos.long()
        toks[rows, idx] = torch.where(can, pick, toks[rows, idx])
        pos.copy_(new_pos)
        return emitted

    # ------------------------------------------------------------ prefill
    def _prompt_bucket(self, n: int) -> int:
        """Power-of-two prompt ladder (bookkeeping only in this port)."""
        b = self.cfg.min_prefill_bucket
        while b < n:
            b <<= 1
        return min(b, self.model.cfg.max_len)

    def _prefill(self, params, slot: int, req: GenerateRequest) -> None:
        """Run ``prompt[:-1]`` through ``decode_step`` on a batch-of-1
        cache — the offline sampler's own arithmetic — then write the row
        into the slot pool (dense) or the slot's pages (paged; quantized
        pools quantize at that write), and arm the slot's state."""
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
        for i in range(p_len - 1):
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
               priority: int = 0) -> PendingResult:
        """Validate + enqueue; returns a handle whose ``result()`` blocks.
        Raises ``ValueError`` on malformed requests (HTTP 400) and
        :class:`~.batcher.QueueFull` under backpressure (HTTP 429)."""
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
        req = GenerateRequest(
            prompt=prompt, max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), seed=int(seed),
            eos_id=eos_id if eos_id is not None else self.cfg.default_eos_id,
            deadline_s=(time.monotonic() + deadline_ms / 1000.0
                        if deadline_ms else None),
            priority=1 if int(priority) > 0 else 0)
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
        step over the all-inactive state, so the first request pays no
        build or first-launch cost."""
        with self.metrics.time("serving.warmup"), torch.no_grad():
            if self.device.type == "cuda":
                build.build_all()
            with self._lock:
                params = self._params
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
                    self._state = self._init_state()

    def _serve_once(self) -> None:
        idle = not self._slots
        n_free = len(self._free)
        if n_free:
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
                self._buckets.add(self._prompt_bucket(len(req.prompt)))
            acquired: list[int] = []
            try:
                if self.cfg.paged:
                    # allocate for what THIS request can touch (positions
                    # [0, limit]); the row's tail parks on the trash page
                    need = -(-(len(req.prompt) + req.max_new_tokens)
                             // self._page_size)
                    acquired = self._pool.alloc(need)
                    row = acquired + [self._num_pages] * (
                        self._pages_per_slot - len(acquired))
                    self._state["bt"][slot] = torch.tensor(
                        row, dtype=torch.int32)
                t_pre = time.perf_counter()
                self._prefill(params, slot, req)
                self.metrics.observe_time("serving.prefill",
                                          time.perf_counter() - t_pre)
            except Exception as e:
                # fail only THIS request; the slot and its pages go back
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
                                          gen=gen)
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

    def _draws(self) -> list:
        """Host-side plan of this step's sampled draws: each sampled slot
        that still generates (``generated < max_new_tokens`` is exactly the
        device's ``pos < limit``) draws once from its own generator."""
        draws = []
        for s, sl in self._slots.items():
            req = sl.pending.request
            if sl.generated < req.max_new_tokens:
                sl.generated += 1
                if sl.gen is not None:
                    draws.append((s, req.temperature, sl.gen))
        return draws

    def _decode_segment(self) -> list:
        """Launch ``resolve_every`` decode steps with NO host syncs — the
        emitted-token tensors stay on the device until ``_resolve``."""
        with self._lock:
            params = self._params
        out = [self._step(params, self._draws())
               for _ in range(self.cfg.resolve_every)]
        self.metrics.increment("serving.decode.dispatches", len(out))
        return out

    def _resolve(self, pending: list, t0: float) -> None:
        """The per-segment fence: ONE host copy of the segment's emitted
        tokens, then EOS/length bookkeeping and metrics."""
        if not pending:
            return
        em = torch.stack(pending).cpu().numpy()              # (k, S)
        now = time.monotonic()
        seg_s = time.perf_counter() - t0
        n_steps = len(pending)
        self.metrics.observe_many("serving.decode_step",
                                  [seg_s / n_steps] * n_steps)
        delivered = 0
        for s in list(self._slots):
            sl = self._slots[s]
            req: GenerateRequest = sl.pending.request
            finish = None
            for t in em[:, s]:
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
                    if sl.first_token_s is not None else None)))

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
                "prefill_buckets": sorted(self._buckets),
                "running": self._thread is not None,
                "warmed": self._warmed,
                "role": self.cfg.role,
                "device": str(self.device),
                "last_error": self._last_error,
            }
        if self._pool is not None:
            out["kv_pages"] = self._num_pages
            out["kv_quant"] = self.cfg.kv_quant
            out["kv_page_bytes"] = self._page_bytes
            out["kv_pages_in_use"] = self._pool.in_use()
        return out


__all__ = ["FILL_BUCKETS", "IMPL_ALIASES", "InferenceEngine", "ServingConfig",
           "kv_page_bytes"]
