"""Data-parallel trainer with an asynchronous, pipelined hot loop — on one
device.

Port of ``deeplearning4j_tpu/parallel/trainer.py`` for a single GPU
(``n_dp = 1``).  A mesh, ``router="hogwild"`` (local SGD with periodic
averaging) and ``zero_stage > 0`` (the sharded weight update) only mean
something across ranks and raise ``NotImplementedError`` naming
``ROADMAP.md`` A10.

Async execution model: PyTorch launches CUDA work asynchronously, so the
Python driver stays ahead of the device as long as nothing on the hot
loop reads a device value on the host.  Three rules keep it so:

1. ``step`` never converts the loss — it returns a :class:`LazyLoss`
   around the 0-d device tensor and parks it on a bounded pending ring;
   ``fit`` resolves the ring in batches (every ``resolve_every`` steps and
   at the end): one event wait on the newest step, then ONE
   ``torch.stack(...).cpu()`` copy of the whole window.  Loss and
   throughput gauges and the NaN guard live at that resolution point.
   When a caller drives ``step`` directly and never resolves, the ring
   fences itself every ``max_pending`` dispatches.
2. Ragged batches pad on the host to a powers-of-two bucket ladder (capped
   at the nominal batch), with a ``train_step.recompile`` count the first
   time a bucket is seen and ``train_step.pad_batch`` /
   ``train_step.padded_samples`` per padded batch — the reference's
   bookkeeping of one compiled step per bucket.  The loss is the exact
   mean over the REAL rows: the losses of this repository are per-row
   means, so the reference's masked mean (per-row losses, pad rows
   weighted 0, divided by the real count) equals ``loss_fn`` over
   ``x[:n_valid]`` up to the order of the sums, and the step computes
   that.  Pad rows are never read, so their contents cannot change it.
3. ``fit`` streams any iterable (no ``list(data)``) and routes host
   batches through :func:`~..datasets.iterator.prefetch_to_device`, which
   copies them from pinned memory on a side stream.

Checkpoints fence the ring before reading params (``checkpoint``), so a
snapshot never races in-flight steps.  ``TrainState.key`` is the
``uint32[2]`` key of the checkpoint format: each step splits it on the
host and seeds the ``torch.Generator`` it hands ``loss_fn`` from one
half.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..datasets.dataset import DataSet
from ..device import resolve_device
from ..observability import METRICS, NOOP_SPAN, enabled as _obs_enabled
from ..observability import sample_device_memory, sample_state_bytes, trace
from ..optimize import transforms as tfm
from ..resilience.faults import FAULTS, DeviceLossError, DivergenceError
from ..utils.tree_math import tree_leaves, tree_map, tree_unflatten

# (params, x, y, gen) -> 0-d tensor, the mean loss over the rows of x
LossFn = Callable[..., torch.Tensor]

_MASK64 = (1 << 64) - 1


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def make_key(seed=None) -> np.ndarray:
    """A ``uint32[2]`` key: ``None`` and an int seed ``s`` give ``[0, s]``
    (the words of the reference's ``jax.random.key(s)``); an array-like
    of two words passes through."""
    if seed is None:
        seed = 0
    if isinstance(seed, (int, np.integer)):
        return np.array([(int(seed) >> 32) & 0xFFFFFFFF,
                         int(seed) & 0xFFFFFFFF], np.uint32)
    key = np.asarray(seed.cpu() if torch.is_tensor(seed) else seed,
                     np.uint32).reshape(-1)
    if key.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {key.shape}")
    return key


def split_key(key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(next key, subkey)`` from a ``uint32[2]`` key, on the host (no
    device work, no sync): splitmix64 of the 64-bit key and its
    successor.  Not the reference's threefry split: the two packages read
    each other's keys but draw different streams from them."""
    s = (int(key[0]) << 32) | int(key[1])
    out = []
    for z in (_splitmix64(s), _splitmix64(s ^ 0xD1B54A32D192ED03)):
        out.append(np.array([z >> 32, z & 0xFFFFFFFF], np.uint32))
    return out[0], out[1]


class LazyLoss:
    """Lazy handle to a device-resident loss.

    ``step`` returns one of these instead of a float: the 0-d tensor stays
    on the device until ``float(handle)`` / ``handle.value()`` reads it.
    ``block()`` waits for the step that produced it without reading it
    (an event wait on a GPU: the fence primitive of the ring)."""

    __slots__ = ("_dev", "_value", "_event")

    def __init__(self, dev: torch.Tensor):
        self._dev = dev
        self._value: float | None = None
        self._event = None
        if dev.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev.device))

    @property
    def resolved(self) -> bool:
        return self._value is not None

    def block(self) -> "LazyLoss":
        if self._value is None and self._event is not None:
            self._event.synchronize()
        return self

    def _set(self, value: float) -> None:
        self._value = value
        self._dev = self._event = None

    def value(self) -> float:
        if self._value is None:
            self._set(float(self._dev))
        return self._value

    __float__ = value

    def __format__(self, spec: str) -> str:
        return format(self.value(), spec)

    def __repr__(self) -> str:
        return (f"LazyLoss({self._value!r})" if self.resolved
                else "LazyLoss(<pending>)")


@dataclasses.dataclass
class TrainState:
    params: Any
    tstate: Any
    step: int
    key: Any


class DataParallelTrainer:
    """A supervised train step on one device, with the reference's async
    loss ring, bucket ladder and checkpoint/restore contract.

    ``loss_fn(params, x, y, gen)`` returns the mean loss over the rows of
    ``x`` as a 0-d tensor (``gen`` is a ``torch.Generator`` on the
    trainer's device, for losses that draw).  ``transform`` is a
    ``GradientTransform`` (``optimize.transforms``).  ``max_pending``
    bounds the ring of unresolved losses."""

    def __init__(self, loss_fn: LossFn, transform: tfm.GradientTransform,
                 mesh=None, router: str = "iterative_reduce",
                 average_every: int = 8, max_pending: int = 64,
                 zero_stage: int = 0, *, device=None):
        if router not in ("iterative_reduce", "hogwild"):
            raise ValueError(f"unknown router {router!r}")
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0..3, got {zero_stage!r}")
        if mesh is not None or router != "iterative_reduce" or zero_stage:
            raise NotImplementedError(
                "a mesh, router='hogwild' and zero_stage > 0 need several "
                "devices and are not ported to deeplearning4j_tpu_torch yet "
                "(ROADMAP.md A10)")
        self.loss_fn = loss_fn
        self.transform = transform
        self.device = resolve_device(device)
        self.router = router
        self.average_every = average_every
        self.max_pending = max(1, max_pending)
        self.n_dp = 1
        self.zero_stage = 0
        self._step_fn = self._build_sync_step()
        # the buckets seen so far (the reference's one compiled step each)
        self._step_cache: dict[int, Any] = {}
        self._nominal: int | None = None
        # pending-loss ring: (LazyLoss, n_real_samples, post-dispatch
        # step); the step rides along so the NaN guard can name it
        self._pending: list[tuple[LazyLoss, int, int]] = []
        self._window_t0: float | None = None
        self._nan_guard = False  # set per fit; checked at resolution

    # ------------------------------------------------------------------ state
    def init_state(self, params, key=None) -> TrainState:
        """Params on the trainer's device (numpy leaves converted), the
        transform's fresh state, step 0 and the key (``make_key``)."""
        params = tree_map(lambda a: torch.as_tensor(a).to(self.device),
                          params)
        with torch.no_grad():
            tstate = self.transform.init(params)
        state = TrainState(params=params, tstate=tstate, step=0,
                           key=make_key(key))
        sample_state_bytes(state.params, state.tstate)
        return state

    # ------------------------------------------------------------------ buckets
    def _bucket_size(self, n: int) -> int:
        """Padded size for a batch of ``n``: powers-of-two ladder rounded to
        the dp width, capped at the nominal (first-seen) batch size."""
        if self._nominal is None:
            self._nominal = _round_up(n, self.n_dp)
        cap = self._nominal
        if n >= cap:
            return _round_up(n, self.n_dp)
        b = 1
        while b < n:
            b <<= 1
        return min(_round_up(b, self.n_dp), cap)

    def _pad_to_bucket(self, x, y):
        """Pad to the bucket size by repeating the rows in order (no index
        tensor, so no device work for device batches).  Returns (x, y,
        n_valid, bucket); the step reads only the first ``n_valid`` rows."""
        n = int(x.shape[0])
        bucket = self._bucket_size(n)
        pad = bucket - n
        if pad:
            if _obs_enabled():
                METRICS.increment("train_step.pad_batch")
                METRICS.increment("train_step.padded_samples", pad)
            reps = -(-pad // n)
            if torch.is_tensor(x):
                x = torch.cat([x] + [x] * reps)[:bucket]
                y = torch.cat([y] + [y] * reps)[:bucket]
            else:
                x = np.concatenate([x] + [x] * reps)[:bucket]
                y = np.concatenate([y] + [y] * reps)[:bucket]
        return x, y, n, bucket

    # ------------------------------------------------------------------ steps
    def _build_sync_step(self):
        """``step(params, tstate, x, y, gen, iteration, n_valid) ->
        (params, tstate, loss)``: value and gradient of ``loss_fn`` over
        the real rows, the transform, ``apply_updates``.  Functional: the
        caller's tensors are not modified; ``loss`` stays on the device."""
        loss_fn, tx = self.loss_fn, self.transform

        def step(params, tstate, x, y, gen, iteration, n_valid):
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            live = tree_unflatten(params, leaves)
            loss = loss_fn(live, x[:n_valid], y[:n_valid], gen)
            grads = tree_unflatten(params, torch.autograd.grad(
                loss, leaves, allow_unused=True, materialize_grads=True))
            with torch.no_grad():
                frozen = tree_unflatten(params, [p.detach() for p in leaves])
                updates, tstate = tx.update(grads, tstate, frozen, iteration)
                params = tfm.apply_updates(frozen, updates)
            return params, tstate, loss.detach()

        return step

    def _step_for(self, bucket: int):
        if bucket not in self._step_cache:
            # first sight of a bucket: the reference compiles a step here
            METRICS.increment("train_step.recompile")
            self._step_cache[bucket] = self._step_fn
        return self._step_cache[bucket]

    # ------------------------------------------------------------------ api
    def step(self, state: TrainState, x, y) -> tuple[TrainState, LazyLoss]:
        """Dispatch one step; returns the new state and a :class:`LazyLoss`.
        The hot loop should leave resolution to ``fit``'s batched fences."""
        x, y, n_valid, bucket = self._pad_to_bucket(x, y)
        return self._dispatch(state, x, y, n_valid, bucket)

    def _dispatch(self, state: TrainState, x, y, n_valid: int,
                  bucket: int) -> tuple[TrainState, LazyLoss]:
        # chaos seam: transient step failure (disarmed cost: one attr test)
        FAULTS.maybe_fire("train.step", state.step + 1)
        # chaos seam: device loss (``kind`` chips; one device has no
        # survivors, and the supervisor's resize is A10)
        if FAULTS.check("mesh.shrink", state.step + 1) is not None:
            raise DeviceLossError(state.step + 1, [self.device])
        obs = _obs_enabled()
        first = bucket not in self._step_cache
        t0 = time.perf_counter() if obs else 0.0
        cm = trace.span("train_step.compile" if first else "train_step",
                        step=state.step, router=self.router) if obs \
            else NOOP_SPAN
        with cm:
            step_fn = self._step_for(bucket)
            state.key, sub = split_key(state.key)
            gen = torch.Generator(device=self.device)
            gen.manual_seed((int(sub[0]) << 32) | int(sub[1]))
            x = torch.as_tensor(x).to(self.device)
            y = torch.as_tensor(y).to(self.device)
            params, tstate, loss = step_fn(state.params, state.tstate, x, y,
                                           gen, state.step, n_valid)
        lazy = LazyLoss(loss)
        if obs:
            # dispatch time only (the loop is async); execution time lands
            # in train_step.execute at resolution
            METRICS.observe_time("train_step.compile" if first
                                 else "train_step", time.perf_counter() - t0)
            METRICS.increment("train_step.iterations")
        if not self._pending:
            self._window_t0 = t0 if obs else time.perf_counter()
        self._pending.append((lazy, n_valid, state.step + 1))
        if len(self._pending) >= self.max_pending:
            self._resolve_pending()  # ring full: self-fence (bounded queue)
        return TrainState(params, tstate, state.step + 1, state.key), lazy

    def _resolve_pending(self) -> list[float]:
        """Fence: wait for the newest pending step (the device runs them in
        dispatch order), read the whole window in ONE copy, then publish
        its metrics and run the NaN guard on the host floats."""
        if not self._pending:
            return []
        entries, self._pending = self._pending, []
        obs = _obs_enabled()
        wait0 = time.perf_counter() if obs else 0.0
        entries[-1][0].block()
        vals = torch.stack([lz._dev.float() for lz, _n, _s in entries]
                           ).cpu().tolist()
        for (lz, _n, _s), v in zip(entries, vals):
            lz._set(v)
        if obs:
            now = time.perf_counter()
            METRICS.observe_time("train_step.resolve_wait", now - wait0)
            METRICS.increment("train_step.losses_resolved", len(vals))
            METRICS.gauge("train_step.loss", vals[-1])
            t0 = self._window_t0
            if t0 is not None and now > t0:
                window = now - t0
                n_samples = sum(n for _, n, _s in entries)
                METRICS.gauge("train_step.samples_per_sec", n_samples / window)
                # amortized per-step execution time over the async window
                METRICS.observe_many(
                    "train_step.execute", [window / len(entries)] * len(entries))
        self._window_t0 = None
        if self._nan_guard:
            for (_lazy, _n, s), v in zip(entries, vals):
                if not np.isfinite(v):
                    METRICS.increment("resilience.nan_detected")
                    raise DivergenceError(s, v)
        return vals

    def abort(self) -> None:
        """Drop the pending-loss ring without resolving — the supervisor's
        retry path discards the in-flight window along with the state that
        produced it, then resumes from the last checkpoint."""
        self._pending.clear()
        self._window_t0 = None
        METRICS.increment("resilience.aborts")

    # ------------------------------------------------------------------ fit
    def _host_stream(self, data, epochs: int, skip: int, prefetch_size: int):
        """Stream (x, y, n_valid, bucket) tuples: host-side bucket padding,
        then double-buffered device copies through ``prefetch_to_device``.
        Accepts a DataSet, a sequence, or a one-shot generator (no
        ``list(data)``); re-iterable inputs replay for ``epochs``, one-shot
        generators stream a single pass."""
        if isinstance(data, DataSet):
            data = (data,)

        def batches():
            idx = 0
            for _ in range(max(1, int(epochs))):
                for b in iter(data):
                    if idx < skip:  # checkpoint-resume cursor
                        idx += 1
                        continue
                    idx += 1
                    # chaos seam: input-pipeline failure mid-stream
                    FAULTS.maybe_fire("data.next", idx)
                    x, y = ((b.features, b.labels)
                            if hasattr(b, "features") else (b[0], b[1]))
                    if not torch.is_tensor(x):
                        x, y = np.asarray(x), np.asarray(y)
                    yield self._pad_to_bucket(x, y)

        if prefetch_size <= 0:
            return batches()
        from ..datasets.iterator import prefetch_to_device
        return prefetch_to_device(batches(), size=prefetch_size,
                                  device=self.device)

    def fit(self, state: TrainState, data: Iterable[DataSet] | DataSet,
            epochs: int = 1, *, checkpoint_manager=None,
            checkpoint_every: int = 0, resume: bool = True,
            async_dispatch: bool = True, resolve_every: int = 32,
            prefetch_size: int = 2, nan_guard: bool = False,
            should_stop: Callable[[int], bool] | None = None,
            extra_skip: int = 0, goodput=None,
            ) -> tuple[TrainState, list[float]]:
        """Run ``epochs`` passes over ``data``, counting steps from
        ``state.step`` — so a state restored from a checkpoint continues
        where it left off.

        ``data`` may be any iterable of batches and is never materialized;
        batches flow host-pad -> prefetch double-buffer -> step.  With
        ``async_dispatch`` (default) losses resolve in batches every
        ``resolve_every`` steps; ``async_dispatch=False`` resolves after
        every step (same steps, same numbers).  Returned losses are floats
        either way.

        With ``checkpoint_manager`` set, saves params + transform state +
        key + data cursor every ``checkpoint_every`` steps and at the end
        (once: a step the loop just saved is not written again) — each save
        fences pending steps first; with ``resume`` (default) restores the
        latest valid checkpoint before training.

        Supervisor hooks (all default-off; see ``resilience/``):
        ``nan_guard`` raises :class:`~..resilience.faults.DivergenceError`
        when a resolved loss is non-finite; ``should_stop(step)`` is polled
        after every dispatch — True drains the ring, writes an emergency
        checkpoint and returns; ``extra_skip`` drops that many more stream
        batches past the resume cursor (the divergence window skip);
        ``goodput`` is an optional
        :class:`~..observability.goodput.GoodputTracker` the loop marks
        with restore/checkpoint/stall/drain intervals (``None`` adds no
        per-step work)."""
        n_known = len(data) if hasattr(data, "__len__") else -1
        self._nan_guard = nan_guard
        with trace.span("trainer.fit", epochs=epochs, n_batches=n_known,
                        router=self.router):
            if checkpoint_manager is not None and resume \
                    and checkpoint_manager.latest_step() is not None:
                if goodput is not None:
                    goodput.transition("restore")
                try:
                    state = self.restore(state, checkpoint_manager)
                except FileNotFoundError:
                    # every on-disk checkpoint failed verification — train
                    # from scratch rather than load corrupt state
                    METRICS.increment("checkpoint.no_valid_restore")
            if goodput is not None:
                # whatever the caller left us in (rollback backoff,
                # restore, drain), dispatching steps is productive time
                goodput.transition("productive")
            handles: list[LazyLoss] = []
            draining = False
            saved = None  # the step the loop last checkpointed
            stream = iter(self._host_stream(
                data, epochs, state.step + extra_skip, prefetch_size))
            while True:
                if goodput is not None:
                    t_fetch = time.perf_counter()
                try:
                    x, y, n_valid, bucket = next(stream)
                except StopIteration:
                    break
                if goodput is not None:
                    goodput.data_wait(t_fetch, time.perf_counter())
                state, lazy = self._dispatch(state, x, y, n_valid, bucket)
                handles.append(lazy)
                if not async_dispatch:
                    self._resolve_pending()  # synchronous path
                elif resolve_every and len(self._pending) >= resolve_every:
                    self._resolve_pending()
                if should_stop is not None and should_stop(state.step):
                    # preemption: drain in-flight steps, snapshot, leave
                    # (goodput: everything from the stop signal to the
                    # return — the emergency save included — is drain)
                    if goodput is not None:
                        goodput.transition("drain")
                    draining = True
                    self._resolve_pending()
                    if checkpoint_manager is not None:
                        self.checkpoint(state, checkpoint_manager)
                        saved = state.step
                    METRICS.increment("resilience.emergency_checkpoints")
                    break
                if (checkpoint_manager is not None and checkpoint_every > 0
                        and state.step % checkpoint_every == 0):
                    if goodput is not None:
                        with goodput.phase("checkpoint"):
                            self.checkpoint(state, checkpoint_manager)
                    else:
                        self.checkpoint(state, checkpoint_manager)
                    saved = state.step
            self._resolve_pending()
            losses = [h.value() for h in handles]
            # the end-of-run save, unless the loop just saved this step
            # (the reference writes the same step a second time)
            if checkpoint_manager is not None and losses \
                    and saved != state.step:
                if goodput is not None and not draining:
                    with goodput.phase("checkpoint"):
                        self.checkpoint(state, checkpoint_manager)
                else:
                    self.checkpoint(state, checkpoint_manager)
        sample_device_memory()  # memory gauges; no-op without CUDA
        return state, losses

    # ------------------------------------------------------------------ ckpt
    def checkpoint(self, state: TrainState, manager,
                   layout: str = "natural") -> None:
        """Fence-then-save: resolve the pending-loss ring, then save params,
        transform state, key and cursor.  One device writes the natural
        layout whatever ``layout`` asks (the flat layout is ZeRO's)."""
        self._resolve_pending()
        METRICS.increment("checkpoint.fences")
        manager.save(state.step, state.params, tstate=state.tstate,
                     key=state.key, data_cursor=state.step,
                     dp_width=int(self.n_dp), zero_stage=self.zero_stage,
                     layout="natural")

    def restore(self, template: TrainState, manager,
                reshard: bool = True) -> TrainState:
        """Restore the newest valid checkpoint into a state shaped like
        ``template`` (fresh ``init_state`` output), on this trainer's
        device.  A checkpoint written at another dp width (the reference's
        ZeRO flat layout included) re-splits exactly on the host; the
        trainer's contract is resharding, so ``reshard`` defaults to True —
        pass False for the strict ``MeshMismatchError`` across widths."""
        r = manager.restore(template.params, tstate_template=template.tstate,
                            reshard=reshard, dp_width=int(self.n_dp))
        tstate = r["tstate"] if r["tstate"] is not None else template.tstate
        key = r["key"] if r["key"] is not None else template.key
        state = TrainState(params=r["params"], tstate=tstate,
                           step=r["step"], key=key)
        sample_state_bytes(state.params, state.tstate)
        return state

    def final_params(self, state: TrainState):
        """The trained parameters (one replica: nothing to collapse)."""
        return state.params
