"""DataSet iterators and the double-buffered host-to-device feed.

Port of ``deeplearning4j_tpu/datasets/iterator.py``: the
``DataSetIterator`` protocol, the fetcher-backed ``BaseDatasetIterator``
(Iris, digits, MNIST, curves, CSV), ``ListDataSetIterator``,
``TestDataSetIterator`` and the wrappers (``MultipleEpochsIterator``,
``SamplingDataSetIterator``, ``ReconstructionDataSetIterator``,
``MovingWindowDataSetIterator``), all host-side numpy as in the
reference; and ``prefetch_to_device``.

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
from typing import Callable, Iterator as PyIterator, Protocol, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .dataset import DataSet
from .fetchers import (
    BaseDataFetcher,
    CSVDataFetcher,
    CurvesDataFetcher,
    DigitsDataFetcher,
    IrisDataFetcher,
    MnistDataFetcher,
)

DataSetPreProcessor = Callable[[DataSet], DataSet]


class DataSetIterator(Protocol):
    """``DataSetIterator.java:10-31`` contract."""

    def next(self, num: int | None = None) -> DataSet: ...
    def has_next(self) -> bool: ...
    def total_examples(self) -> int: ...
    def input_columns(self) -> int: ...
    def total_outcomes(self) -> int: ...
    def reset(self) -> None: ...
    def batch(self) -> int: ...
    def cursor(self) -> int: ...
    def set_pre_processor(self, pre: DataSetPreProcessor) -> None: ...


class _IterBase:
    """Python-iteration sugar shared by all iterators."""

    def __iter__(self) -> PyIterator[DataSet]:
        self.reset()
        while self.has_next():
            yield self.next()


class BaseDatasetIterator(_IterBase):
    """Fetcher-backed iterator (``BaseDatasetIterator.java``)."""

    def __init__(self, batch_size: int, num_examples: int, fetcher: BaseDataFetcher):
        self._batch = batch_size
        self._num_examples = num_examples if num_examples > 0 else fetcher.total_examples()
        self.fetcher = fetcher
        self.pre_processor: DataSetPreProcessor | None = None

    def has_next(self) -> bool:
        return self.fetcher.has_more() and self.fetcher.cursor < self._num_examples

    def next(self, num: int | None = None) -> DataSet:
        n = num or self._batch
        # honor the num_examples cap (fetch clamps only to the full corpus)
        n = min(n, self._num_examples - self.fetcher.cursor)
        self.fetcher.fetch(n)
        ds = self.fetcher.next()
        return self.pre_processor(ds) if self.pre_processor else ds

    def total_examples(self) -> int:
        return self._num_examples

    def input_columns(self) -> int:
        self.fetcher._ensure_loaded()
        return self.fetcher.input_columns

    def total_outcomes(self) -> int:
        self.fetcher._ensure_loaded()
        return self.fetcher.num_outcomes

    def reset(self) -> None:
        self.fetcher.reset()

    def batch(self) -> int:
        return self._batch

    def cursor(self) -> int:
        return self.fetcher.cursor

    def set_pre_processor(self, pre: DataSetPreProcessor) -> None:
        self.pre_processor = pre


class IrisDataSetIterator(BaseDatasetIterator):
    """``IrisDataSetIterator``."""

    def __init__(self, batch: int = 150, num_examples: int = 150):
        super().__init__(batch, num_examples, IrisDataFetcher())


class DigitsDataSetIterator(BaseDatasetIterator):
    """Offline 8x8-digits iterator (fast MNIST-class corpus for tests)."""

    def __init__(self, batch: int = 100, num_examples: int = 0, **kw):
        super().__init__(batch, num_examples, DigitsDataFetcher(**kw))


class MnistDataSetIterator(BaseDatasetIterator):
    """``MnistDataSetIterator`` (IDX-file MNIST w/ offline fallback)."""

    def __init__(self, batch: int = 100, num_examples: int = 0, **kw):
        super().__init__(batch, num_examples, MnistDataFetcher(**kw))


class CurvesDataSetIterator(BaseDatasetIterator):
    """``CurvesDataSetIterator`` (synthesized curves; see the fetcher)."""

    def __init__(self, batch: int = 100, num_examples: int = 0, **kw):
        super().__init__(batch, num_examples, CurvesDataFetcher(**kw))


class CSVDataSetIterator(BaseDatasetIterator):
    """``CSVDataSetIterator``."""

    def __init__(self, batch: int, num_examples: int, path, label_col: int = -1, **kw):
        super().__init__(batch, num_examples, CSVDataFetcher(path, label_col, **kw))


class ListDataSetIterator(_IterBase):
    """``ListDataSetIterator`` — iterate over an in-memory list of examples."""

    def __init__(self, data: DataSet | Sequence[DataSet], batch: int = 10):
        ds = data if isinstance(data, DataSet) else DataSet.merge(list(data))
        self.data = ds
        self._batch = batch
        self._cursor = 0
        self.pre_processor: DataSetPreProcessor | None = None

    def has_next(self) -> bool:
        return self._cursor < self.data.num_examples()

    def next(self, num: int | None = None) -> DataSet:
        n = num or self._batch
        end = min(self._cursor + n, self.data.num_examples())
        ds = DataSet(self.data.features[self._cursor:end], self.data.labels[self._cursor:end])
        self._cursor = end
        return self.pre_processor(ds) if self.pre_processor else ds

    def total_examples(self) -> int:
        return self.data.num_examples()

    def input_columns(self) -> int:
        return self.data.num_inputs()

    def total_outcomes(self) -> int:
        return self.data.num_outcomes()

    def reset(self) -> None:
        self._cursor = 0

    def batch(self) -> int:
        return self._batch

    def cursor(self) -> int:
        return self._cursor

    def set_pre_processor(self, pre: DataSetPreProcessor) -> None:
        self.pre_processor = pre


class TestDataSetIterator(ListDataSetIterator):
    """``datasets/test/TestDataSetIterator.java`` — wrap any DataSet for
    tests (main-tree fixture in the reference as well)."""

    __test__ = False  # not a pytest class despite the name


# --------------------------------------------------------------------------- wrappers

class MultipleEpochsIterator(_IterBase):
    """``MultipleEpochsIterator.java`` — replay an iterator N epochs."""

    def __init__(self, num_epochs: int, inner):
        self.num_epochs = num_epochs
        self.inner = inner
        self.epoch = 0

    def has_next(self) -> bool:
        return self.epoch < self.num_epochs - 1 or self.inner.has_next()

    def next(self, num: int | None = None) -> DataSet:
        if not self.inner.has_next():
            self.inner.reset()
            self.epoch += 1
        return self.inner.next(num)

    def reset(self) -> None:
        self.epoch = 0
        self.inner.reset()

    def total_examples(self) -> int:
        return self.inner.total_examples() * self.num_epochs

    def input_columns(self) -> int:
        return self.inner.input_columns()

    def total_outcomes(self) -> int:
        return self.inner.total_outcomes()

    def batch(self) -> int:
        return self.inner.batch()

    def cursor(self) -> int:
        return self.inner.cursor()

    def set_pre_processor(self, pre) -> None:
        self.inner.set_pre_processor(pre)


class SamplingDataSetIterator(_IterBase):
    """``SamplingDataSetIterator`` — draw with-replacement samples from a
    base DataSet for a fixed number of batches."""

    def __init__(self, data: DataSet, batch: int, total_batches: int, seed: int = 0):
        self.data = data
        self._batch = batch
        self.total_batches = total_batches
        self._count = 0
        self._rng = np.random.default_rng(seed)
        self.pre_processor: DataSetPreProcessor | None = None

    def has_next(self) -> bool:
        return self._count < self.total_batches

    def next(self, num: int | None = None) -> DataSet:
        n = num or self._batch
        idx = self._rng.choice(self.data.num_examples(), size=n, replace=True)
        self._count += 1
        ds = DataSet(self.data.features[idx], self.data.labels[idx])
        return self.pre_processor(ds) if self.pre_processor else ds

    def reset(self) -> None:
        self._count = 0

    def total_examples(self) -> int:
        return self._batch * self.total_batches

    def input_columns(self) -> int:
        return self.data.num_inputs()

    def total_outcomes(self) -> int:
        return self.data.num_outcomes()

    def batch(self) -> int:
        return self._batch

    def cursor(self) -> int:
        return self._count * self._batch

    def set_pre_processor(self, pre) -> None:
        self.pre_processor = pre


class ReconstructionDataSetIterator(_IterBase):
    """``ReconstructionDataSetIterator`` — labels become the features
    (unsupervised pretraining view)."""

    def __init__(self, inner):
        self.inner = inner

    def has_next(self) -> bool:
        return self.inner.has_next()

    def next(self, num: int | None = None) -> DataSet:
        return self.inner.next(num).as_reconstruction()

    def reset(self) -> None:
        self.inner.reset()

    def total_examples(self) -> int:
        return self.inner.total_examples()

    def input_columns(self) -> int:
        return self.inner.input_columns()

    def total_outcomes(self) -> int:
        return self.inner.input_columns()

    def batch(self) -> int:
        return self.inner.batch()

    def cursor(self) -> int:
        return self.inner.cursor()

    def set_pre_processor(self, pre) -> None:
        self.inner.set_pre_processor(pre)


class MovingWindowDataSetIterator(_IterBase):
    """``MovingWindowBaseDataSetIterator.java:12`` — slide a (rows, cols)
    window over each example image and emit the flattened windows as
    examples (same labels)."""

    def __init__(self, batch: int, data: DataSet, window_rows: int, window_cols: int):
        feats = data.features
        if feats.ndim == 2:
            side = int(np.sqrt(feats.shape[1]))
            feats = feats.reshape(-1, side, side)
        elif feats.ndim == 4:
            feats = feats[..., 0]
        windows, labels = [], []
        for i in range(feats.shape[0]):
            img = feats[i]
            for r in range(0, img.shape[0] - window_rows + 1, window_rows):
                for c in range(0, img.shape[1] - window_cols + 1, window_cols):
                    windows.append(img[r:r + window_rows, c:c + window_cols].reshape(-1))
                    labels.append(data.labels[i])
        self._list = ListDataSetIterator(
            DataSet(np.stack(windows), np.stack(labels)), batch)

    def __getattr__(self, name):
        return getattr(self._list, name)

    def __iter__(self):
        return iter(self._list)




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

    def __init__(self, device: torch.device, sharding=None):
        self.device = device
        self.sharding = sharding
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def _rows(self, x):
        """This rank's block of ``x`` under the sharding (0-d leaves pass
        whole)."""
        from ..parallel.mesh import local_block

        if self.sharding is None or x.ndim == 0:
            return x
        return local_block(x, self.sharding)

    def stage(self, batch):
        """``(batch on the device, the copies' event or None, the copied
        tensors)``."""
        if self.sharding is not None:
            batch = _map(batch, self._rows)
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
    ``parallel.mesh.NamedSharding``, as the trainer's batch placement)
    stages only this rank's block of each array (its rows of the global
    batch, under ``P('dp')``), each rank of the mesh its own."""
    stager = _Stager(resolve_device(device), sharding)
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
