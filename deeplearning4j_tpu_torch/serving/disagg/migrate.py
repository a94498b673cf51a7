"""KV-page migration between serving tiers.

Port of ``deeplearning4j_tpu/serving/disagg/migrate.py``.  A migrated
request is pages plus a block-table row, both portable already; this
module adds the protocol: a per-request transfer schedule (which pages
move, which transfer as hash-only claims), the reference handoff on the
decode side, and an unwind that releases every reference it acquired.

Content addressing: the decode pool's prefix cache keys chains of full
token pages by chained blake2b, the same keys the prefill side's pages
carry, so a page already resident on the decode side transfers as a
claim (one reference, no bytes).  Only content pages beyond the resident
prefix ship bytes; pages that exist only as decode budget are allocated
empty on arrival.

:meth:`InferenceEngine.read_pages` exports whatever the pool stores
(``k``/``v``, and ``k_scale``/``v_scale`` under kv_quant; float, int8 or
fp8), and the import writes those bytes as they are: a moved page is
byte-identical to the page the prefill wrote, with no requantization.

The wire form (``POST /v1/migrate``) is the reference's: each array as
base64 bytes, a numpy dtype NAME and a shape.  The names
:data:`WIRE_DTYPES` lists map to torch dtypes here, and the bytes move
through ``uint8`` views, so no numpy extension dtype (bfloat16, fp8) is
needed: a payload either package exports imports into the other.

Failure contract: an unwind anywhere releases the decode-side claims via
:meth:`PagePool.decref_quarantine` and hands the dead pages to the decode
engine's serve thread for wiping.  The prefill-side record stays with the
caller until its bytes are read, then is released; migrating again after
any abort is safe.
"""

from __future__ import annotations

import base64
import dataclasses
import math
import time

import torch

from ...observability import METRICS
from ...resilience.faults import FAULTS
from ..batcher import GenerateRequest, PendingResult
from ..engine import MigrationRejected, MigrationTicket, PrefillRecord

__all__ = ["KVMigrator", "PageTransfer", "TransferPlan", "export_payload"]

#: wire dtype names (numpy's, as the reference writes them) -> torch
WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
               "bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn, "int8": torch.int8}
_WIRE_NAMES = {v: k for k, v in WIRE_DTYPES.items()}


@dataclasses.dataclass
class PageTransfer:
    """One block-table position in a migration schedule."""

    index: int            # position in the block-table row
    key: str | None       # chained content hash (None: no full-page key)
    action: str           # "claim" | "move" | "alloc"


@dataclasses.dataclass
class TransferPlan:
    """Per-request transfer schedule: for every page the request needs on
    the decode side, a hash-only claim (resident: one reference, no
    bytes), a byte move (prefill content the decode side lacks) or a
    bare allocation (decode budget, nothing to move)."""

    entries: list[PageTransfer]

    def count(self, action: str) -> int:
        return sum(1 for e in self.entries if e.action == action)

    @property
    def pages_moved(self) -> int:
        return self.count("move")

    @property
    def pages_deduped(self) -> int:
        return self.count("claim")


def _page_counts(prompt_len: int, max_new: int, page_size: int):
    """(content pages, total pages) of a request: the prefill writes K/V
    for positions ``[0, p-1)`` (the last prompt token is the first
    decode query), so ``ceil((p-1)/ps)`` pages carry bytes; the rest of
    the ``ceil((p+max_new)/ps)`` row is decode budget."""
    n_content = -(-(prompt_len - 1) // page_size)
    n_total = -(-(prompt_len + max_new) // page_size)
    return n_content, n_total


def _plan(keys: list[str], n_claim: int, n_content: int,
          n_total: int) -> TransferPlan:
    return TransferPlan([
        PageTransfer(index=i, key=keys[i] if i < len(keys) else None,
                     action=("claim" if i < n_claim
                             else "move" if i < n_content else "alloc"))
        for i in range(n_total)])


class KVMigrator:
    """Moves prefilled requests into a decode engine's page pool.

    The page accounting of the tier funnels through here: the export
    seam (:meth:`export_payload`: read the bytes, release the prefill
    record) and the import seam (:meth:`migrate` / :meth:`import_payload`:
    claim, allocate, upload, hand off to
    :meth:`InferenceEngine.admit_from_pages`)."""

    def __init__(self, decode_engine):
        if decode_engine.page_pool is None:
            raise ValueError("decode engine must be paged — the "
                             "migration unit is a KV page")
        if decode_engine.cfg.role == "prefill":
            raise ValueError("cannot migrate INTO a prefill-role engine")
        self.decode = decode_engine

    # ------------------------------------------------------------ planning
    def plan_transfer(self, prompt: list[int], max_new_tokens: int,
                      cached_len: int | None = None) -> TransferPlan:
        """Advisory schedule for migrating ``prompt``: which block-table
        positions claim, move or allocate.  ``cached_len`` overrides the
        decode pool's :meth:`~..paging.PagePool.peek_prefix` answer.
        Advisory, because the import re-walks the chain atomically and
        may find more or fewer resident pages: :meth:`migrate` returns
        the plan as executed."""
        pool = self.decode.page_pool
        ps = pool.page_size
        usable = len(prompt) - 1
        if cached_len is None:
            cached_len = pool.peek_prefix(prompt, usable)
        n_content, n_total = _page_counts(len(prompt), max_new_tokens, ps)
        return _plan(pool.chain_keys(prompt, usable), cached_len // ps,
                     n_content, n_total)

    # ------------------------------------------------------------ live path
    def migrate(self, src, record: PrefillRecord,
                pending: PendingResult) -> tuple[MigrationTicket,
                                                 TransferPlan]:
        """Move ``record``'s KV from prefill engine ``src`` into the decode
        engine and queue ``pending`` for admission between decode
        segments.  Returns the admission ticket and the plan as executed.

        The decode-side pages pass to
        :meth:`~..engine.InferenceEngine.admit_from_pages`; ``record`` is
        consumed (its pages released on the prefill side) once its bytes
        are read.  On any unwind before that the record is untouched (the
        caller releases or retries it) and every decode-side reference
        taken here is quarantined back."""
        pool = self.decode.page_pool
        ps = pool.page_size
        prompt = record.prompt
        usable = len(prompt) - 1
        n_content, n_total = _page_counts(len(prompt),
                                          record.max_new_tokens, ps)
        with METRICS.time("disagg.migrate_seconds"):
            FAULTS.maybe_fire("disagg.migrate")
            claimed: list[int] = []
            fresh: list[int] = []
            try:
                # the generation stamp BEFORE the claim: a reload landing
                # between here and admission makes the drain fence reject
                # the ticket, so claimed pages computed under superseded
                # weights never decode
                gen = int(self.decode.stats()["generation"])
                claimed, _cached = pool.lookup_prefix(prompt, usable)
                n_claim = len(claimed)
                fresh = pool.alloc(n_total - n_claim)
                # mid-migration kill point: references held on both sides,
                # nothing admitted; the unwind must balance them exactly
                FAULTS.maybe_fire("disagg.migrate")
                uploads = []
                if n_claim < n_content:
                    raw = src.read_pages(record.pages[n_claim:n_content])
                    for j in range(n_content - n_claim):
                        uploads.append((fresh[j], [
                            {name: arr[j] for name, arr in layer.items()}
                            for layer in raw]))
            except BaseException:
                self.decode.queue_wipe(
                    pool.decref_quarantine(claimed + fresh))
                raise
            # the bytes are read: the prefill side's copy is redundant
            src.release_prefill(record)
            plan = _plan(pool.chain_keys(prompt, usable), n_claim,
                         n_content, n_total)
            METRICS.increment("disagg.migrations")
            METRICS.increment("disagg.pages_moved", len(uploads))
            METRICS.increment("disagg.pages_deduped", n_claim)
            METRICS.increment("disagg.bytes_moved", _upload_bytes(uploads))
            try:
                ticket = self.decode.admit_from_pages(
                    pending, pages=claimed + fresh, uploads=uploads,
                    generation=gen)
            except BaseException:
                self.decode.queue_wipe(
                    pool.decref_quarantine(claimed + fresh))
                raise
            return ticket, plan

    # ------------------------------------------------------------ wire form
    @staticmethod
    def export_payload(src, record: PrefillRecord,
                       cached_len: int = 0) -> dict:
        """Serialize ``record`` for a cross-process migration (``POST
        /v1/migrate``): the request, the per-page content hashes, and the
        bytes of the content pages beyond ``cached_len`` positions (a
        probe of the decode side; 0 ships everything).  Consumes the
        record.  ``pages[str(i)]`` is block-row position ``i``'s payload,
        a list a layer of ``{name: {b64, dtype, shape}}``."""
        ps = src.cfg.page_size
        prompt = record.prompt
        n_content, _n_total = _page_counts(len(prompt),
                                           record.max_new_tokens, ps)
        skip = min(cached_len // ps, n_content)
        keys = src.page_pool.chain_keys(prompt, len(prompt) - 1)
        pages: dict[str, list] = {}
        if skip < n_content:
            raw = src.read_pages(record.pages[skip:n_content])
            for j in range(n_content - skip):
                pages[str(skip + j)] = [
                    {name: _encode_arr(arr[j])
                     for name, arr in layer.items()}
                    for layer in raw]
        src.release_prefill(record)
        return {
            "request": {
                "prompt": list(prompt),
                "max_new_tokens": record.max_new_tokens,
                "temperature": record.temperature,
                "seed": record.seed,
                "eos_id": record.eos_id,
            },
            "page_size": ps,
            "hashes": keys,
            "pages": pages,
        }

    def import_payload(self, payload: dict) -> PendingResult:
        """Import a wire-form migration: claim what is resident, upload
        the provided bytes for the rest, and queue the request for
        admission.  Raises ``RuntimeError`` (HTTP 409) when a needed
        content page has neither resident nor wire bytes (the probed
        prefix was evicted since: re-export with full bytes).  Returns
        the pending handle."""
        req_d = payload["request"]
        prompt = [int(t) for t in req_d["prompt"]]
        max_new = int(req_d["max_new_tokens"])
        pool = self.decode.page_pool
        ps = int(payload.get("page_size") or pool.page_size)
        if ps != pool.page_size:
            raise ValueError(
                f"page_size mismatch: exporter {ps}, decode side "
                f"{pool.page_size} — migration requires identical page "
                "geometry")
        n_content, n_total = _page_counts(len(prompt), max_new, ps)
        wire = payload.get("pages") or {}
        gen = int(self.decode.stats()["generation"])
        claimed: list[int] = []
        fresh: list[int] = []
        try:
            claimed, _cached = pool.lookup_prefix(prompt, len(prompt) - 1)
            n_claim = len(claimed)
            for i in range(n_claim, n_content):
                if str(i) not in wire:
                    raise RuntimeError(
                        f"migration payload missing bytes for content "
                        f"page {i} (claimed {n_claim} resident) — the "
                        "probed prefix was evicted; re-export with full "
                        "bytes")
            fresh = pool.alloc(n_total - n_claim)
            uploads = []
            for j, i in enumerate(range(n_claim, n_content)):
                uploads.append((fresh[j], [
                    {name: _decode_arr(enc) for name, enc in layer.items()}
                    for layer in wire[str(i)]]))
        except BaseException:
            self.decode.queue_wipe(pool.decref_quarantine(claimed + fresh))
            raise
        eos = req_d.get("eos_id")
        req = GenerateRequest(
            prompt=prompt, max_new_tokens=max_new,
            temperature=float(req_d.get("temperature") or 0.0),
            seed=int(req_d.get("seed") or 0),
            eos_id=int(eos) if eos is not None else None)
        req.submitted_s = time.monotonic()
        pending = PendingResult(req)
        METRICS.increment("disagg.migrations")
        METRICS.increment("disagg.pages_moved", len(uploads))
        METRICS.increment("disagg.pages_deduped", n_claim)
        METRICS.increment("disagg.bytes_moved", _upload_bytes(uploads))
        try:
            ticket = self.decode.admit_from_pages(
                pending, pages=claimed + fresh, uploads=uploads,
                generation=gen)
        except BaseException:
            self.decode.queue_wipe(pool.decref_quarantine(claimed + fresh))
            raise
        if not ticket.wait(timeout=60.0):
            # the drain fence released the pages; the request was never
            # admitted: single-shot HTTP semantics answer 409
            if not pending.done():
                pending._fail(MigrationRejected(ticket.reason or
                                                "migration rejected"))
            raise RuntimeError(
                f"migration rejected at admission: {ticket.reason} — "
                "safe to retry")
        return pending


def _upload_bytes(uploads) -> int:
    """Page bytes an upload list carries (every layer's arrays)."""
    return sum(t.numel() * t.element_size() for _, layers in uploads
               for layer in layers for t in layer.values())


def _encode_arr(t: torch.Tensor) -> dict:
    t = t.detach().cpu().contiguous()
    if t.dtype not in _WIRE_NAMES:
        raise ValueError(f"no wire name for dtype {t.dtype}")
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return {"b64": base64.b64encode(raw).decode("ascii"),
            "dtype": _WIRE_NAMES[t.dtype], "shape": list(t.shape)}


def _decode_arr(enc: dict) -> torch.Tensor:
    name = enc["dtype"]
    if name not in WIRE_DTYPES:
        raise ValueError(f"unsupported wire dtype {name!r} (supported: "
                         f"{sorted(WIRE_DTYPES)})")
    dt = WIRE_DTYPES[name]
    shape = [int(d) for d in enc["shape"]]
    raw = bytearray(base64.b64decode(enc["b64"]))
    itemsize = torch.empty((), dtype=dt).element_size()
    if len(raw) != math.prod(shape) * itemsize or not raw:
        raise ValueError(f"wire array of {len(raw)} bytes does not hold "
                         f"{name} {shape}")
    return torch.frombuffer(raw, dtype=torch.uint8).view(dt).reshape(shape)


#: module-level alias: the server's export path needs no migrator
export_payload = KVMigrator.export_payload
