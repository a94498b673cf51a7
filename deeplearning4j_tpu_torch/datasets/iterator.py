"""Double-buffered host-to-device feed.

Port of ``prefetch_to_device`` from
``deeplearning4j_tpu/datasets/iterator.py``; the dataset iterators there
come with the capability set (``ROADMAP.md`` A9).

On a GPU each batch is copied from pinned host memory with
``non_blocking=True`` on a side stream, so the copy of batch k+1 overlaps
the compute of batch k.  Two rules keep that safe:

- the consumer's stream waits for the batch's copy (an event recorded on
  the side stream after it) before the batch is handed over, so a step
  never reads a half-copied batch;
- each copied tensor is ``record_stream``-ed on the consumer's stream:
  the tensor was allocated on the side stream, and without this the
  caching allocator could hand its memory to the next copy while the step
  still reads it.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading

import torch

from ..device import resolve_device


def _map(batch, fn):
    """``fn`` over the array leaves (anything with a ``shape``) of tuples,
    lists and dicts; other leaves (the trainer's python-int sample counts)
    pass through untouched."""
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        items = [_map(x, fn) for x in batch]
        return (type(batch)(*items) if hasattr(batch, "_fields")
                else type(batch)(items))
    return fn(batch) if hasattr(batch, "shape") else batch


class _Stager:
    """Copies batches onto ``device``: through pinned memory and a side
    stream on a GPU, directly on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def stage(self, batch):
        """``(batch on the device, the copies' event or None, the copied
        tensors)``."""
        if self.stream is None:
            return _map(batch, lambda x: torch.as_tensor(x).to(
                self.device)), None, []
        copied = []

        def copy(x):
            t = torch.as_tensor(x)
            if t.device == self.device:
                return t
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            out = t.to(self.device, non_blocking=True)
            copied.append(out)
            return out

        with torch.cuda.stream(self.stream):
            out = _map(batch, copy)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return out, ev, copied

    def hand_over(self, staged):
        """The batch, safe to read on the caller's current stream."""
        batch, ev, copied = staged
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for t in copied:
                t.record_stream(cur)
        return batch


class _ThreadedPrefetch:
    """Background-thread variant of :func:`prefetch_to_device`.

    A daemon worker pulls from the source iterable, stages each batch on
    the device, and parks it in a bounded queue, so the consumer never
    blocks on host-side batch production.  The worker exits on source
    exhaustion, on error (re-raised in the consumer), and on ``close()`` —
    it never outlives the iterator, even when the consumer abandons
    iteration mid-stream with a full queue.
    """

    _DONE = object()  # sentinel: source exhausted

    def __init__(self, iterable, size: int, stager: _Stager):
        self._q: _queue.Queue = _queue.Queue(maxsize=max(1, size))
        self._stop = threading.Event()
        self._err_lock = threading.Lock()
        self._error: BaseException | None = None  # guarded-by: self._err_lock
        self._source = iterable
        self._stager = stager
        self.thread = threading.Thread(
            target=self._work, name="prefetch_to_device", daemon=True)
        self.thread.start()

    def _put(self, item) -> None:
        # stop-aware put: a plain blocking put on a full queue would
        # deadlock close() when the consumer walked away
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except _queue.Full:
                continue

    def _work(self):
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                self._put(self._stager.stage(batch))
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            with self._err_lock:
                self._error = e
        finally:
            self._put(self._DONE)

    def __iter__(self):
        return self

    def _take_error(self):
        """Claim the worker error (swap-out, at most one claimant wins)."""
        with self._err_lock:
            err, self._error = self._error, None
        return err

    def _peek_error(self) -> bool:
        with self._err_lock:
            return self._error is not None

    def __next__(self):
        while True:
            err = self._take_error()
            if err is not None:
                self.close()
                raise err
            try:
                item = self._q.get(timeout=0.05)
            except _queue.Empty:
                if not self.thread.is_alive() and self._q.empty() \
                        and not self._peek_error():
                    raise StopIteration from None
                continue
            if item is self._DONE:
                if self._peek_error():
                    continue  # surface the error on the next spin
                self.close()
                raise StopIteration
            return self._stager.hand_over(item)

    def close(self):
        """Stop the worker and join it (idempotent)."""
        self._stop.set()
        # drain so a worker blocked in put() sees the stop flag promptly
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        if self.thread.is_alive():
            self.thread.join(timeout=5.0)

    def __del__(self):  # best effort — close() is the contract
        try:
            self._stop.set()
        except Exception:
            pass


def prefetch_to_device(iterable, size: int = 2, sharding=None,
                       host_thread: bool = False, *, device=None):
    """Double-buffered host-to-device staging: up to ``size`` batches are
    copied ahead of the consumer (see the module docstring for the copy
    stream).  Works on ``(features, labels)`` tuples or any nest of tuples,
    lists and dicts of host arrays; ``device`` defaults to ``cuda``.

    With ``host_thread=True`` a daemon worker also produces the batches
    (generator work: parsing, padding) ahead of the consumer, and the
    result has ``close()`` for deterministic shutdown.  ``sharding`` (a
    placement over a mesh) comes with the multi-device port (``ROADMAP.md``
    A10) and raises."""
    if sharding is not None:
        raise NotImplementedError(
            "prefetch_to_device(sharding=...): meshes are not ported to "
            "deeplearning4j_tpu_torch yet (ROADMAP.md A10)")
    stager = _Stager(resolve_device(device))
    if host_thread:
        return _ThreadedPrefetch(iterable, size, stager)

    def _threadless():
        ahead = collections.deque()
        it = iter(iterable)
        try:
            while len(ahead) < max(1, size):
                ahead.append(stager.stage(next(it)))
        except StopIteration:
            pass
        while ahead:
            out = ahead.popleft()
            try:
                ahead.append(stager.stage(next(it)))
            except StopIteration:
                pass
            yield stager.hand_over(out)

    return _threadless()
