"""Host-side bookkeeping for the paged KV cache.

Port of ``deeplearning4j_tpu/serving/paging.py``: ``PagePool`` (free-list,
refcounts, the trash-page convention) and the content-addressed prefix
cache.

The device side is deliberately dumb: per-layer ``(num_pages, page_size,
Kv, Dh)`` pools (int8 with per-page scales under ``kv_quant``, addressed
by the same page ids) plus an ``(S, pages_per_slot)`` int32 block table
in the engine's state.  Everything stateful lives HERE, on the host,
under one leaf lock, so the decode loop never synchronizes on allocation
metadata.  The engine appends one extra physical trash page OUTSIDE this
pool for the writes of inactive slots.  The pool never touches device
tensors: acquire/release hand back page ids and the engine gathers,
scatters and wipes pages at its fences.

Prefix cache: content addressing is a chained hash over FULL token pages
— ``h_k = H(h_{k-1} || tokens[(k-1)*ps : k*ps])`` — so a lookup walks the
chain until the first miss and aliases the longest cached run.  A prompt
of length ``p`` prefills K/V for positions ``[0, p-1)`` (the last token is
the first decode query), so a chain of ``k`` pages is usable only when
``k * page_size <= p - 1``.  Cache entries PIN their pages with a
refcount and slots aliasing them add one more each; a page is freed (and
wiped by the engine) only when its count reaches zero, so an aliased page
is never reused or zeroed under a reader.  Sharing int8 pages stays sound
because quantized rewrites of identical content are byte-identical
(monotone per-page scales, ``ops/cuda/kv_quant.py``).
"""

from __future__ import annotations

import hashlib
import threading

from .batcher import PagePoolExhausted


def prefix_chain_keys(tokens: list[int], usable: int,
                      page_size: int) -> list[str]:
    """Chained hashes for every full token page covering positions
    ``< usable``: key ``i`` addresses K/V for ``tokens[: (i+1)*ps]`` and,
    being chained, commits to the whole prefix, not just its own page.
    The JAX package's keys exactly (same hash, same byte encoding), so a
    router can place requests for either package's replicas."""
    keys: list[str] = []
    h = b"kv-prefix-v1"
    for k in range(1, usable // page_size + 1):
        block = tokens[(k - 1) * page_size: k * page_size]
        h = hashlib.blake2b(
            h + (",".join(map(str, block))).encode(), digest_size=16,
        ).digest()
        keys.append(h.hex())
    return keys


class PrefixEntry:
    """One cached chain: the first ``len(pages)`` full token pages of
    some prompt, pinned (one refcount per page) until LRU-evicted."""

    __slots__ = ("pages", "tick")

    def __init__(self, pages: tuple[int, ...], tick: int):
        self.pages = pages
        self.tick = tick


class PagePool:
    """Free-list + refcounts + prefix cache over ``num_pages`` usable
    pages."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self._lock = threading.Lock()
        self._free = list(range(num_pages))          # guarded-by: self._lock
        self._ref = [0] * num_pages                  # guarded-by: self._lock
        self._prefix: dict[str, PrefixEntry] = {}    # guarded-by: self._lock
        self._tick = 0                               # guarded-by: self._lock
        self._lookups = 0                            # guarded-by: self._lock
        self._hits = 0                               # guarded-by: self._lock

    # -- content addressing ---------------------------------------------
    def chain_keys(self, tokens: list[int], usable: int) -> list[str]:
        """See :func:`prefix_chain_keys`."""
        return prefix_chain_keys(tokens, usable, self.page_size)

    # -- acquire side ---------------------------------------------------
    def lookup_prefix(self, tokens: list[int], usable: int):
        """Longest cached chain of full token pages covering at most
        ``usable`` positions.  Every matched page is increffed FOR THE
        CALLER before return, so a later LRU eviction can drop the entry
        but never free the pages under the new reader.  Returns
        ``(pages, cached_positions)``."""
        keys = self.chain_keys(tokens, usable)
        with self._lock:
            self._lookups += 1
            best: PrefixEntry | None = None
            for key in keys:
                entry = self._prefix.get(key)
                if entry is None:
                    break
                best = entry
            if best is None:
                return [], 0
            self._hits += 1
            self._tick += 1
            best.tick = self._tick
            for p in best.pages:
                self._ref[p] += 1
            return list(best.pages), len(best.pages) * self.page_size

    def peek_prefix(self, tokens: list[int], usable: int) -> int:
        """How many leading positions are cached right now, with no
        incref and no LRU touch (advisory)."""
        keys = self.chain_keys(tokens, usable)
        with self._lock:
            depth = 0
            for key in keys:
                entry = self._prefix.get(key)
                if entry is None:
                    break
                depth = len(entry.pages)
            return depth * self.page_size

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` fresh pages (refcount 1 each), LRU-evicting prefix
        entries as needed; raises :class:`PagePoolExhausted` when even a
        drained cache cannot cover them."""
        with self._lock:
            while len(self._free) < n and self._evict_lru_locked():
                pass
            if len(self._free) < n:
                raise PagePoolExhausted(
                    f"KV page pool exhausted: need {n} pages, "
                    f"{len(self._free)}/{self.num_pages} free and no "
                    "evictable prefix entries — retry when slots drain")
            out = [self._free.pop() for _ in range(n)]
            for p in out:
                self._ref[p] = 1
            return out

    def insert_prefix(self, tokens: list[int], pages: list[int],
                      usable: int) -> None:
        """Publish every full-page chain of ``tokens[:usable]`` backed by
        the slot's ``pages`` (block-table order).  Each new entry pins its
        pages with one more refcount; chains already present are only
        touched (their pages hold the same K/V)."""
        keys = self.chain_keys(tokens, usable)
        with self._lock:
            for i, key in enumerate(keys):
                self._tick += 1
                if key in self._prefix:
                    self._prefix[key].tick = self._tick
                    continue
                chain = tuple(pages[: i + 1])
                for p in chain:
                    self._ref[p] += 1
                self._prefix[key] = PrefixEntry(chain, self._tick)

    # -- release side ---------------------------------------------------
    def decref(self, pages: list[int]) -> list[int]:
        """Drop one reference per page; returns the pages whose count
        reached zero (now back on the free list) so the caller can wipe
        them on the device.  Aliased pages (count still > 0) are not
        returned: they must be neither wiped nor reused."""
        with self._lock:
            return self._decref_locked(pages)

    def _decref_locked(self, pages, quarantine: bool = False) -> list[int]:
        """With ``quarantine=True`` dead pages are reported but NOT put on
        the free list: the caller wipes them and hands them back through
        :meth:`requeue`."""
        freed: list[int] = []
        for p in pages:
            if self._ref[p] <= 0:
                raise AssertionError(f"page {p} refcount underflow")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                if not quarantine:
                    self._free.append(p)
                freed.append(p)
        return freed

    def decref_quarantine(self, pages: list[int]) -> list[int]:
        """:meth:`decref` whose dead pages are QUARANTINED (off the books,
        not reallocatable) until the caller wipes them and calls
        :meth:`requeue`: wipe-before-reallocatable for a releaser that
        cannot touch the device itself."""
        with self._lock:
            return self._decref_locked(pages, quarantine=True)

    def clear_prefix(self) -> list[int]:
        """Drop every prefix entry (cached chains hold K/V of the weights
        they were computed under).  Pages whose cache pin was the last
        reference are quarantined and returned, to be wiped and then
        :meth:`requeue`-d; pages live slots still alias stay pinned by
        their readers, untouched."""
        with self._lock:
            quarantined: list[int] = []
            for key in list(self._prefix):
                entry = self._prefix.pop(key)
                quarantined.extend(
                    self._decref_locked(list(entry.pages), quarantine=True))
            return quarantined

    def requeue(self, pages: list[int]) -> None:
        """Return quarantined (now wiped) pages to the free list."""
        with self._lock:
            self._free.extend(pages)

    def _evict_lru_locked(self) -> bool:
        """Drop the least-recently-touched prefix entry (its pin only:
        slots still aliasing the pages keep them alive)."""
        if not self._prefix:
            return False
        key = min(self._prefix, key=lambda k: self._prefix[k].tick)
        entry = self._prefix.pop(key)
        self._decref_locked(list(entry.pages))
        return True

    def reset(self) -> None:
        """Forget everything (serve-loop crash recovery)."""
        with self._lock:
            self._free = list(range(self.num_pages))
            self._ref = [0] * self.num_pages
            self._prefix.clear()

    # -- introspection --------------------------------------------------
    def in_use(self) -> int:
        with self._lock:
            return self.num_pages - len(self._free)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._ref[page]

    def prefix_entries(self) -> int:
        with self._lock:
            return len(self._prefix)

    def refcounts(self) -> list[int]:
        """Snapshot of every page's refcount (leak audits)."""
        with self._lock:
            return list(self._ref)

    def hit_rate(self) -> float:
        with self._lock:
            return self._hits / self._lookups if self._lookups else 0.0

    def hit_counts(self) -> tuple[int, int]:
        """``(hits, lookups)``, absolute, for pool-weighted aggregation."""
        with self._lock:
            return self._hits, self._lookups
