"""Data-parallel trainer with an asynchronous, pipelined hot loop.

Port of ``deeplearning4j_tpu/parallel/trainer.py``.  The reference is one
jitted step over a ``jax.sharding.Mesh``; the port is SPMD over the ranks
of a :class:`~.mesh.Mesh` (``torch.distributed`` process groups): every
rank runs this trainer on the same global batches, stages its own rows of
each (``prefetch_to_device(sharding=...)``) and meets the others in the
collectives of ``parallel/collectives``.  ``mesh=None`` is the world's
ranks (one process without a process group: one device, no collective).
Both of the reference's routing policies exist:

- **iterative-reduce**: replicated params, the batch split over ``dp``;
  each rank's gradient is its local sum of per-row losses seeded with
  ``1/n_valid`` (the reference's arithmetic, ``trainer.py:370-385``), and
  one all-reduce sums them.  ``zero_stage`` 1-3 shard the weight update
  (``ZeroLayout``): stage 1 all-reduces and keeps this rank's chunk,
  stages >= 2 reduce-scatter (full gradients never land), stage 3 keeps
  the params sharded between steps and gathers them each step.  The
  gradients cross in one buffer, rank-major over the flat padded leaves,
  so stage 0 and stage 1 are the same reduction and the same floats.
- **hogwild**: local SGD with periodic averaging — each rank trains its
  own replica on its rows with no cross-rank traffic, and every
  ``average_every`` steps one all-reduce averages the replicas.

A rank outside the trainer's mesh (an elastic resize's quarantined rank)
is a spectator: it walks the stream and the fault and stop polls at the
members' steps and computes nothing, so it can rejoin at a later resize.

Async execution model: PyTorch launches CUDA work asynchronously, so the
Python driver stays ahead of the device as long as nothing on the hot
loop reads a device value on the host.  Three rules keep it so:

1. ``step`` never converts the loss — it returns a :class:`LazyLoss`
   around the 0-d device tensor and parks it on a bounded pending ring;
   ``fit`` resolves the ring in batches (every ``resolve_every`` steps and
   at the end): one event wait on the newest step, then ONE
   ``torch.stack(...).cpu()`` copy of the whole window (under hogwild one
   all-reduce averages the window's replica losses).  Loss and
   throughput gauges and the NaN guard live at that resolution point.
   When a caller drives ``step`` directly and never resolves, the ring
   fences itself every ``max_pending`` dispatches.
2. Ragged batches pad on the host to a powers-of-two bucket ladder (capped
   at the nominal batch, rounded to the dp width), with a
   ``train_step.recompile`` count the first time a bucket is seen and
   ``train_step.pad_batch`` / ``train_step.padded_samples`` per padded
   batch — the reference's bookkeeping of one compiled step per bucket.
   The loss is the exact mean over the REAL rows: the losses of this
   repository are per-row means, so on one device the reference's masked
   mean equals ``loss_fn`` over ``x[:n_valid]`` up to the order of the
   sums, and across ranks each rank's real rows weigh ``1/n_valid``.  Pad
   rows are never read, so their contents cannot change it.
3. ``fit`` streams any iterable (no ``list(data)``) and routes host
   batches through :func:`~..datasets.iterator.prefetch_to_device`, which
   copies this rank's rows from pinned memory on a side stream.

The steady-state ``fit`` loop runs under
:func:`~..analysis.runtime.hot_loop_guard`: a host sync in it raises at
its call site (opt out: ``DL4J_TPU_TRANSFER_GUARD=0``).  Its deliberate
syncs — the ring's resolution, checkpoints, the setup and the final pull
— are ``allow_transfers()`` fences, and the step callables dispatch
through ``SHARDGUARD.wrap`` (``train.sync_step`` with the declared
placements, ``train.zero_step`` against its first call's).

Checkpoints fence the ring before reading params (``checkpoint``), so a
snapshot never races in-flight steps; ZeRO state is gathered to natural
shapes (or flat, ``layout="flat"``), the mesh's first rank writes, and
the others wait at a barrier.  ``TrainState.key`` is the ``uint32[2]``
key of the checkpoint format: each step splits it on the host and seeds
the ``torch.Generator`` it hands ``loss_fn`` from one half (under
hogwild, mixed with the rank's dp index).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..analysis.runtime import allow_transfers, hot_loop_guard
from ..analysis.shardguard import SHARDGUARD
from ..datasets.dataset import DataSet
from ..device import resolve_device
from ..observability import COSTS, METRICS, NOOP_SPAN, enabled as _obs_enabled
from ..observability import sample_device_memory, sample_state_bytes, trace
from ..optimize import transforms as tfm
from ..resilience.faults import FAULTS, DeviceLossError, DivergenceError
from ..utils.tree_math import tree_leaves, tree_map, tree_unflatten
from . import collectives as clv
from .checkpoint import publish_from_first_rank
from .compile_cache import setup_compile_cache
from .mesh import (DP, NamedSharding, P, dp_width, local_block, local_mesh,
                   mesh_devices)
from .zero import ZeroLayout

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
    (an event wait on a GPU: the fence primitive of the ring).  A
    hogwild step's handle holds this rank's replica loss and resolves
    through the trainer's ring (``resolver``), whose one all-reduce
    averages the replicas, as the reference's ``value()`` means its
    per-replica vector."""

    __slots__ = ("_dev", "_value", "_event", "_resolver")

    def __init__(self, dev: torch.Tensor):
        self._dev = dev
        self._value: float | None = None
        self._event = None
        self._resolver = None
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
        self._dev = self._event = self._resolver = None

    def value(self) -> float:
        if self._value is None and self._resolver is not None:
            self._resolver()
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
    """A supervised train step over the ``dp`` ranks of a mesh, with the
    reference's async loss ring, bucket ladder and checkpoint/restore
    contract.

    ``loss_fn(params, x, y, gen)`` returns the mean loss over the rows of
    ``x`` as a 0-d tensor (``gen`` is a ``torch.Generator`` on the
    trainer's device, for losses that draw).  ``transform`` is a
    ``GradientTransform`` (``optimize.transforms``).  ``mesh`` defaults to
    every rank of the world (``local_mesh()``).  ``max_pending`` bounds
    the ring of unresolved losses.  Every rank of the mesh runs the same
    calls with the same global batches; ``n_dp`` is the mesh's width and
    ``member`` whether this rank is in it."""

    def __init__(self, loss_fn: LossFn, transform: tfm.GradientTransform,
                 mesh=None, router: str = "iterative_reduce",
                 average_every: int = 8, max_pending: int = 64,
                 zero_stage: int = 0, *, device=None):
        if router not in ("iterative_reduce", "hogwild"):
            raise ValueError(f"unknown router {router!r}")
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0..3, got {zero_stage!r}")
        if zero_stage and router != "iterative_reduce":
            raise ValueError(
                "zero_stage requires the iterative_reduce router — hogwild "
                "keeps independent per-replica optimizer state by design, "
                "so there is no shared state to shard")
        self.loss_fn = loss_fn
        self.transform = transform
        self.mesh = mesh if mesh is not None else local_mesh()
        self.device = resolve_device(device)
        self.router = router
        self.average_every = average_every
        self.max_pending = max(1, max_pending)
        self.n_dp = dp_width(self.mesh)
        self.member = self.mesh.member
        # over a process group (even of one rank) the step runs the
        # collective path; without one, the one-device step
        self._coll = self.mesh.group is not None
        # ZeRO stage: 0 replicates grads + optimizer state; 1 shards the
        # optimizer state (all-reduce grads, update this rank's chunk,
        # all-gather params); 2 reduce-scatters grads; 3 also keeps the
        # params sharded between steps
        self.zero_stage = int(zero_stage)
        self._zero: ZeroLayout | None = None  # built at init_state
        # placements: batches split over dp, everything else replicated
        self._batch_sh = NamedSharding(self.mesh, P(DP))
        self._rep_sh = NamedSharding(self.mesh, P())
        # the buckets seen so far (the reference's one compiled step each)
        self._step_cache: dict[int, Any] = {}
        self._nominal: int | None = None
        # pending-loss ring: (LazyLoss, n_real_samples, post-dispatch
        # step); the step rides along so the NaN guard can name it
        self._pending: list[tuple[LazyLoss, int, int]] = []
        self._window_t0: float | None = None
        self._nan_guard = False  # set per fit; checked at resolution
        # flops and bytes of one step, counted at the first sight of a
        # bucket (COSTS) — the live train.mfu/mbu gauges at every fence
        self._step_cost = None
        setup_compile_cache()  # the kernel build cache (env-gated no-op)

    # ------------------------------------------------------------------ state
    # one-shot setup: the params' upload is a sanctioned sync point
    @allow_transfers()
    def init_state(self, params, key=None) -> TrainState:
        """Params on the trainer's device (numpy leaves converted; under
        ZeRO stage 3 this rank's flat chunks), the transform's fresh state
        (under ZeRO born rank-local: this rank's chunk of every leaf),
        step 0 and the key (``make_key``)."""
        params = tree_map(lambda a: torch.as_tensor(a).to(self.device),
                          params)
        with torch.no_grad():
            if self.zero_stage >= 1 or self._coll:
                # the flat layout also packs the multi-rank reductions
                self._zero_layout(params)
            if self.zero_stage >= 1:
                z = self._zero
                tstate = tfm.init_sharded(self.transform,
                                          z.flatten_tree(params), P(DP),
                                          self.mesh)
                if self.zero_stage >= 3:
                    params = z.place_flat(params, z.flat_sharding)
            else:
                tstate = self.transform.init(params)
        state = TrainState(params=params, tstate=tstate, step=0,
                           key=make_key(key))
        sample_state_bytes(state.params, state.tstate)  # ZeRO memory gauges
        return state

    def _zero_layout(self, params) -> ZeroLayout:
        """Build (once) the flatten/pad/shard metadata (shapes only)."""
        if self._zero is None:
            self._zero = ZeroLayout(self.mesh, self.transform, params)
        return self._zero

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
    def _value_and_grads(self, params, x, y, gen, n_valid, n_rows=None):
        """``(value, grads)`` over this rank's real rows of ``x``.  On one
        device (no process group): the mean loss over ``x[:n_valid]`` and
        its gradient.  Over ranks: this rank's sum of per-row losses over
        its real rows (``loss_fn``'s mean times their count) and its
        gradient seeded with ``1/n_valid`` — the reference's local masked
        sum and cotangent, so the sum over ranks is the global mean and
        its gradient.  ``n_rows`` (hogwild) overrides: the mean over this
        rank's own real rows.  A rank without real rows contributes
        zeros."""
        loss_fn = self.loss_fn
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        if not self._coll and n_rows is None:
            value = loss_fn(live, x[:n_valid], y[:n_valid], gen)
            seed = None
        else:
            lo = self.mesh.axis_index(DP) * x.shape[0]
            n_local = max(0, min(n_valid - lo, x.shape[0]))
            if n_rows is not None:
                n_local = n_rows
            if n_local == 0:
                zero = torch.zeros((), device=self.device)
                return zero, tree_unflatten(params, [torch.zeros_like(p)
                                                     for p in leaves])
            value = loss_fn(live, x[:n_local], y[:n_local], gen)
            seed = None
            if n_rows is None:
                value = value * n_local
                seed = torch.full((), 1.0 / n_valid, dtype=value.dtype,
                                  device=value.device)
        grads = torch.autograd.grad(value, leaves, grad_outputs=seed,
                                    allow_unused=True, materialize_grads=True)
        return value.detach(), tree_unflatten(params, list(grads))

    def _pack(self, tree):
        """The flat padded leaves of the natural ``tree`` in one
        rank-major buffer: rank 0's chunk of every leaf, then rank
        1's, ... — what one all-reduce or reduce-scatter moves."""
        z = self._zero
        flats = [f.float() if f.dtype != torch.float32 else f
                 for f in tree_leaves(z.flatten_tree(tree))]
        return torch.cat([f.view(self.n_dp, -1) for f in flats],
                         dim=1).reshape(-1)

    def _unpack(self, buf, like, ranks: str):
        """Leaves of ``like``'s tree from a packed buffer: ``ranks="all"``
        (an all-reduced or gathered buffer) gives the full flat padded
        leaves, each in its own allocation (as ``apply_updates`` gives
        stage 0 its params: a GEMM's rounding may follow its operand's
        alignment), ``"mine"`` this rank's chunks; from a reduce-scattered
        buffer (this rank's part only), ``"local"`` gives its chunks."""
        z = self._zero
        leaves = tree_leaves(like)
        sizes = [z.chunk_size(int(np.prod(t.shape, dtype=np.int64))
                              if t.dim() else 1) for t in leaves]
        rows = buf.view(-1 if ranks != "local" else 1, sum(sizes))
        if ranks == "mine":
            rows = rows[self.mesh.axis_index(DP)][None]
        out, off = [], 0
        for t, k in zip(leaves, sizes):
            leaf = rows[:, off:off + k].reshape(-1)
            out.append(leaf.to(t.dtype, copy=ranks == "all"))
            off += k
        return tree_unflatten(like, out)

    def _build_sync_step(self):
        """``step(params, tstate, x, y, gen, iteration, n_valid) ->
        (params, tstate, loss)`` for stage 0 over this rank's rows of the
        batch: the gradient (one all-reduce of the packed buffer across
        ranks), the transform, ``apply_updates``.  Functional: the
        caller's tensors are not modified; ``loss`` stays on the device."""
        tx, mesh = self.transform, self.mesh

        def step(params, tstate, x, y, gen, iteration, n_valid):
            value, grads = self._value_and_grads(params, x, y, gen, n_valid)
            with torch.no_grad(), mesh:
                if self._coll:
                    z = self._zero
                    loss = clv.psum(value, DP) / n_valid
                    buf = clv.psum(self._pack(grads), DP)
                    grads = z.unflatten_like(
                        self._unpack(buf, z.natural_params, "all"),
                        z.natural_params)
                else:
                    loss = value
                frozen = tree_map(lambda p: p.detach(), params)
                updates, tstate = tx.update(grads, tstate, frozen, iteration)
                params = tfm.apply_updates(frozen, updates)
            return params, tstate, loss

        # explicit mode: the params, state and loss replicated on this
        # rank's device, the batch split over dp — a drifted placement
        # upstream (a leaf left on the host, a global batch where this
        # rank's rows belong) is counted instead of silently computed on
        rep, bat = self._rep_sh, self._batch_sh
        return SHARDGUARD.wrap("train.sync_step", step,
                               in_shardings=(rep, rep, bat, bat),
                               out_shardings=(rep, rep, rep),
                               device=self.device)

    def _build_zero_step(self):
        """The ZeRO sharded weight update (zero_stage >= 1):

        local grads -> stage 1: all-reduce + keep this rank's chunk
                       stage >= 2: reduce-scatter (full grads never land)
        -> ``transform.update`` on this rank's flat chunk only
        -> stage <= 2: all-gather the updated chunks, natural shapes
           stage 3: the params stay chunks; the next step gathers them.

        Each exchange is one collective over the packed buffer.  Stage 1
        is the stage-0 reduction, so it gives stage 0's floats;
        norm-coupled transforms (clip_unit_norm, clip_by_global_norm)
        would see chunk-local norms and are not exact here, as in the
        reference."""
        mesh, n_dp, stage, coll = (self.mesh, self.n_dp, self.zero_stage,
                                   self._coll)
        z = self._zero
        if z is None:
            raise RuntimeError("zero step built before init_state — the "
                               "layout comes from the param shapes")
        tx = self.transform
        nat_t = z.natural_params

        def step(params, tstate, x, y, gen, iteration, n_valid):
            with mesh:
                if stage >= 3:
                    with torch.no_grad():
                        full = clv.all_gather(
                            torch.cat([c.reshape(-1).float()
                                       for c in tree_leaves(params)]),
                            DP, tiled=True) if coll else None
                        flat = (self._unpack(full, nat_t, "all")
                                if coll else params)
                        nat = z.unflatten_like(flat, nat_t)
                else:
                    nat = params
                value, grads = self._value_and_grads(nat, x, y, gen, n_valid)
                with torch.no_grad():
                    if coll:
                        loss = clv.psum(value, DP) / n_valid
                        buf = self._pack(grads)
                        if stage == 1:
                            gchunk = self._unpack(clv.psum(buf, DP), nat_t,
                                                  "mine")
                        else:
                            gchunk = self._unpack(
                                clv.reduce_scatter(buf, DP), nat_t, "local")
                    else:
                        loss = value
                        gchunk = z.flatten_tree(grads)
                    if stage >= 3:
                        pchunk = params
                    else:
                        pchunk = z.chunk_tree(
                            z.flatten_tree(tree_map(lambda p: p.detach(),
                                                    nat)),
                            mesh.axis_index(DP), nat_t)
                    # decay classification from the NATURAL shapes: on
                    # 1-D chunks ndim >= 2 would decay nothing
                    with tfm.decay_mask_override(z.decay_mask):
                        updates, tstate = tx.update(gchunk, tstate, pchunk,
                                                    iteration)
                    pchunk = tfm.apply_updates(pchunk, updates)
                    if stage >= 3:
                        return pchunk, tstate, loss
                    if coll:
                        full = clv.all_gather(
                            torch.cat([c.float() for c in
                                       tree_leaves(pchunk)]), DP, tiled=True)
                        pchunk = self._unpack(full, nat_t, "all")
                    return z.unflatten_like(pchunk, nat_t), tstate, loss

        # baseline mode: the ZeRO placements are emergent (stage-dependent
        # chunks), so the first dispatch captures them and later drift is
        # the violation
        return SHARDGUARD.wrap("train.zero_step", step)

    def _build_local_step(self):
        """Hogwild local step: this rank's replica on its own real rows
        (the mean over them), no cross-rank traffic."""
        tx = self.transform

        def step(params, tstate, x, y, gen, iteration, n_valid):
            lo = self.mesh.axis_index(DP) * x.shape[0]
            n_local = max(0, min(n_valid - lo, x.shape[0]))
            value, grads = self._value_and_grads(params, x, y, gen, n_valid,
                                                 n_rows=n_local)
            with torch.no_grad():
                frozen = tree_map(lambda p: p.detach(), params)
                updates, tstate = tx.update(grads, tstate, frozen, iteration)
                params = tfm.apply_updates(frozen, updates)
            return params, tstate, value

        return step

    def _average(self, params):
        """Periodic replica averaging: one all-reduce (mean) of the packed
        params."""
        if not self._coll:
            return params
        z = self._zero
        with torch.no_grad(), self.mesh:
            buf = clv.psum(self._pack(params), DP) \
                / self.n_dp
            return z.unflatten_like(
                self._unpack(buf, z.natural_params, "all"), z.natural_params)

    def _step_for(self, bucket: int):
        fn = self._step_cache.get(bucket)
        if fn is None:
            # first sight of a bucket: the reference compiles a step here
            METRICS.increment("train_step.recompile")
            if self.router == "iterative_reduce":
                fn = (self._build_zero_step() if self.zero_stage
                      else self._build_sync_step())
            else:
                fn = self._build_local_step()
            self._step_cache[bucket] = fn
        return fn

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a no-op off it or alone)."""
        if self.member and self.n_dp > 1:
            with self.mesh:
                clv.barrier_sum(DP)

    def _local_rows(self, x, bucket: int):
        """This rank's rows of a global bucket-padded batch (a batch the
        prefetcher already split passes as it is)."""
        if self.n_dp > 1 and self.member and x.shape[0] == bucket:
            return local_block(x, self._batch_sh)
        return x

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
        # chaos seam: device loss — ``kind`` is the number of ranks that
        # "die" (default 1, leaving at least one survivor where the mesh
        # has several).  Every rank checks the same step, so all raise
        # DeviceLossError naming the same ranks and the supervisor
        # rebuilds the mesh from the survivors on each of them.
        spec = FAULTS.check("mesh.shrink", state.step + 1)
        if spec is not None:
            devs = mesh_devices(self.mesh)
            k = int(spec.kind) if str(spec.kind or "").isdigit() else 1
            k = max(1, min(k, len(devs) - 1)) if len(devs) > 1 else 1
            raise DeviceLossError(state.step + 1, devs[-k:])
        if not self.member:
            # a spectator keeps the members' step count and key, nothing
            # else (no pending entry: it has no loss)
            state.key, _ = split_key(state.key)
            lazy = LazyLoss(torch.zeros(()))
            lazy._set(float("nan"))
            return (TrainState(state.params, state.tstate, state.step + 1,
                               state.key), lazy)
        obs = _obs_enabled()
        first = bucket not in self._step_cache
        t0 = time.perf_counter() if obs else 0.0
        cm = trace.span("train_step.compile" if first else "train_step",
                        step=state.step, router=self.router) if obs \
            else NOOP_SPAN
        with cm:
            step_fn = self._step_for(bucket)
            state.key, sub = split_key(state.key)
            seed = (int(sub[0]) << 32) | int(sub[1])
            if self.router == "hogwild":
                # independent replicas draw independent streams
                seed = _splitmix64(seed ^ self.mesh.axis_index(DP))
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            x = self._upload(self._local_rows(x, bucket))
            y = self._upload(self._local_rows(y, bucket))
            if first and obs and not self._coll:
                # counted on fake copies of the arguments: nothing runs
                # (a multi-rank step's collectives cannot run on them)
                self._step_cost = COSTS.capture(
                    f"train_step.b{bucket}", step_fn, state.params,
                    state.tstate, x, y, gen, state.step, n_valid)
            params, tstate, loss = step_fn(state.params, state.tstate, x, y,
                                           gen, state.step, n_valid)
            if self.router == "hogwild" \
                    and (state.step + 1) % self.average_every == 0:
                params = self._average(params)
                if obs:
                    METRICS.increment("train_step.periodic_average")
        lazy = LazyLoss(loss)
        if self.router == "hogwild" and self._coll:
            lazy._resolver = self._resolve_pending
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

    def _upload(self, a) -> torch.Tensor:
        """A batch array on the trainer's device.  A host array crosses
        from pinned memory, asynchronously (a pageable copy makes the
        host wait, which the hot loop's guard refuses); a batch
        ``prefetch_to_device`` already staged passes as it is."""
        t = torch.as_tensor(a)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _resolve_pending(self) -> list[float]:
        """Fence: wait for the newest pending step (the device runs them in
        dispatch order), read the whole window in ONE copy, then publish
        its metrics and run the NaN guard on the host floats."""
        if not self._pending:
            return []
        entries, self._pending = self._pending, []
        obs = _obs_enabled()
        wait0 = time.perf_counter() if obs else 0.0
        # a handle the caller already read keeps its value
        unread = [lz for lz, _n, _s in entries if not lz.resolved]
        if unread:
            # the ring's one read: a fence inside the guarded fit loop
            with allow_transfers():
                unread[-1].block()
                window = torch.stack([lz._dev.float() for lz in unread])
                if self.router == "hogwild" and self._coll:
                    # the replicas' losses, averaged: one all-reduce a
                    # window
                    with self.mesh:
                        window = clv.pmean(window, DP)
                for lz, v in zip(unread, window.cpu().tolist()):
                    lz._set(v)
        vals = [lz.value() for lz, _n, _s in entries]
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
                # live MFU/MBU: one step's counted work over the amortized
                # per-step execution time
                COSTS.publish_utilization(
                    self._step_cost, window / len(entries),
                    "train.mfu", "train.mbu")
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
        sharding = self._batch_sh if self.n_dp > 1 and self.member else None
        return prefetch_to_device(batches(), size=prefetch_size,
                                  sharding=sharding, device=self.device)

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
            # steady state runs under the transfer guard: a host sync in
            # the loop raises unless it sits in an allow_transfers() fence
            # (opt out via DL4J_TPU_TRANSFER_GUARD=0; see analysis.runtime)
            with hot_loop_guard():
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
                    if self.member:
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
    # the save pulls every leaf to the host: a sanctioned sync point,
    # also when called inside the guarded fit loop
    @allow_transfers()
    def checkpoint(self, state: TrainState, manager,
                   layout: str = "natural") -> None:
        """Fence-then-save: resolve the pending-loss ring, gather what the
        ranks hold (collective over the mesh), and let the mesh's first
        rank write while the others wait at a barrier.

        ``layout="natural"`` (default) gathers ZeRO state back to natural
        shapes — the width-agnostic on-disk format.  ``layout="flat"``
        writes the flat padded ``P('dp')`` leaves (gathered whole); the
        manager stamps the save-side width so a restore at any other
        width re-splits host-side, exactly.  Hogwild writes the replicas
        stacked on a leading dp axis, as the reference's sharded leaves.
        A rank outside the mesh writes nothing."""
        self._resolve_pending()
        METRICS.increment("checkpoint.fences")
        if not self.member:
            return
        flat = layout == "flat" and self.zero_stage >= 1
        params, tstate, extra = state.params, state.tstate, None
        with torch.no_grad(), self.mesh:
            if self.router == "hogwild":
                def stack(v):
                    return (clv.all_gather(v, DP) if torch.is_tensor(v)
                            else v)
                params, tstate = tree_map(stack, params), \
                    tree_map(stack, tstate)
            if self.zero_stage >= 1:
                z = self._zero
                if flat:
                    def whole(v):
                        return (clv.all_gather_or_identity(v, DP, self.n_dp)
                                if torch.is_tensor(v) else v)
                    tstate = tree_map(whole, tstate)
                    if self.zero_stage >= 3:
                        params = tree_map(whole, params)
                else:
                    tstate = z.to_natural_host(tstate, z.natural_tstate)
                    if self.zero_stage >= 3:
                        params = z.to_natural_host(params, z.natural_params)
                extra = {"zero_stage": self.zero_stage,
                         "saved_dp": int(self.n_dp)}
        publish_from_first_rank(
            manager, self.mesh, state.step, params, tstate=tstate,
            key=state.key, data_cursor=state.step, extra=extra,
            dp_width=int(self.n_dp), zero_stage=self.zero_stage,
            layout="flat" if flat else "natural")

    def restore(self, template: TrainState, manager,
                reshard: bool = True) -> TrainState:
        """Restore the newest valid checkpoint into a state shaped like
        ``template`` (fresh ``init_state`` output) on this trainer's
        device; every rank reads the files and keeps its own part.

        Under zero_stage >= 1 the checkpoint holds the natural layout (or
        the flat save-side one the manager re-splits), re-flattened here
        into this rank's chunks — a checkpoint written at dp=2 restores
        at dp=1 and back.  The trainer's contract is resharding, so
        ``reshard`` defaults to True; pass False for the strict
        ``MeshMismatchError`` across widths.  A rank outside the mesh
        takes the newest step's number only (it computes nothing)."""
        if not self.member:
            step = manager.latest_step()
            return TrainState(template.params, template.tstate,
                              template.step if step is None else step,
                              template.key)
        if self.zero_stage >= 1:
            state = self._restore_zero(template, manager, reshard=reshard)
        elif self.router == "hogwild":
            state = self._restore_replicas(template, manager, reshard)
        else:
            r = manager.restore(template.params,
                                tstate_template=template.tstate,
                                reshard=reshard, dp_width=int(self.n_dp))
            tstate = r["tstate"] if r["tstate"] is not None \
                else template.tstate
            key = r["key"] if r["key"] is not None else template.key
            state = TrainState(params=r["params"], tstate=tstate,
                               step=r["step"], key=key)
        sample_state_bytes(state.params, state.tstate)  # ZeRO memory gauges
        return state

    def _restore_replicas(self, template: TrainState, manager,
                          reshard: bool) -> TrainState:
        """Hogwild: the checkpoint stacks one replica a rank; this rank
        keeps its row."""
        idx = self.mesh.axis_index(DP)

        def stacked(t):
            return (torch.empty((self.n_dp,) + tuple(t.shape), dtype=t.dtype,
                                device="meta") if torch.is_tensor(t) else t)

        def mine(v, t):
            return v[idx].to(t.device) if torch.is_tensor(t) else v

        r = manager.restore(tree_map(stacked, template.params),
                            tstate_template=tree_map(stacked,
                                                     template.tstate),
                            reshard=reshard, dp_width=int(self.n_dp))
        tstate = (tree_map(mine, r["tstate"], template.tstate)
                  if r["tstate"] is not None else template.tstate)
        key = r["key"] if r["key"] is not None else template.key
        return TrainState(tree_map(mine, r["params"], template.params),
                          tstate, r["step"], key)

    # restore is a sanctioned sync point like save: loading the leaves
    # and re-placing them is setup, not the hot loop
    @allow_transfers()
    def _restore_zero(self, template: TrainState, manager,
                      reshard: bool = True) -> TrainState:
        """Load a natural-layout checkpoint against the layout's natural
        templates, then flatten each tree into this rank's chunks."""
        z = self._zero
        if z is None:
            # under stage 3 the template's params are already chunks, so
            # the natural shapes must come from init_state's layout
            if self.zero_stage >= 3:
                raise RuntimeError(
                    "zero_stage=3 restore needs a template from init_state")
            z = self._zero_layout(template.params)
        r = manager.restore(z.natural_params, tstate_template=z.natural_tstate,
                            reshard=reshard, dp_width=int(self.n_dp))
        with torch.no_grad():
            nat = tree_map(lambda a: a.to(self.device), r["params"])
            params = (z.place_flat(nat, z.flat_sharding)
                      if self.zero_stage >= 3 else nat)
            tstate = template.tstate
            if r["tstate"] is not None:
                tstate = z.place_flat(r["tstate"], z.state_shardings,
                                      device=self.device)
        key = r["key"] if r["key"] is not None else template.key
        return TrainState(params=params, tstate=tstate, step=r["step"],
                          key=key)

    @allow_transfers()   # the one-shot post-fit pull
    def final_params(self, state: TrainState):
        """One natural param set: the replicas averaged under hogwild, the
        chunks gathered and unflattened under zero_stage 3 (both
        collective over the mesh; a rank outside it gets its params as
        they are)."""
        if not self.member:
            return state.params
        if self.zero_stage >= 3:
            z = self._zero
            with torch.no_grad(), self.mesh:
                if self._coll:
                    full = clv.all_gather(
                        torch.cat([c.reshape(-1).float()
                                   for c in tree_leaves(state.params)]),
                        DP, tiled=True)
                    flat = self._unpack(full, z.natural_params, "all")
                else:
                    flat = state.params
                return z.unflatten_like(flat, z.natural_params)
        if self.router == "hogwild":
            return self._average(state.params)
        return state.params
