"""The collectives layer: ``torch.distributed`` over a mesh axis.

Port of ``deeplearning4j_tpu/parallel/collectives.py``.  The reference's
wrappers run inside ``shard_map`` and name a mesh axis; here they run in
every rank of the active mesh (``with mesh:``, see ``parallel.mesh``) and
reach the process group of this rank's line along the axis they name
(``psum``/``pmean`` also take a tuple of axes, as ``lax.psum`` does).
Each returns a new tensor and leaves its input alone, as the reference's
do.  Without a process group, and over a one-wide axis, every one of
them is the identity (a sum of one shard is the shard), so one-device
code calls them freely.

Autograd crosses them as JAX's transposes do: ``psum``'s backward is a
psum of the cotangent, ``pmean``'s a pmean, and ``ppermute``'s the
inverse permutation of the cotangent (the backward that ring attention
and the pipeline's micro-batch hand-off rely on).  The tensor-parallel
pair is :func:`copy_to_tp` (identity forward, psum backward) and
:func:`reduce_from_tp` (psum forward, identity backward).  Every rank
must reach the same collectives in the same order, in the backward too:
code over a mesh keeps one op sequence on every rank and selects with
tensor masks where ranks differ (``models.pipeline``), so autograd runs
the same graph in the same order everywhere.

Transport.  NCCL runs them all on CUDA tensors.  Gloo runs CPU tensors,
and CUDA tensors for ``all_reduce`` and ``broadcast``; where gloo refuses
a CUDA tensor for another collective, that collective is staged through
pinned host memory, explicitly: the first refusal is remembered per
(backend, collective), and every staged call counts
``collectives.host_staged`` and ``collectives.host_staged.<name>`` in the
metrics registry.  Gloo's point-to-point sends take host tensors only, so
a ``ppermute`` of a CUDA tensor over gloo is always staged, and counted
the same way.  Nothing here changes the backend or the device on its
own.

:data:`STATS` keeps, per collective, its calls, bytes and host seconds
(a gloo call returns when its data has arrived, an NCCL call when it is
enqueued), and :data:`AXIS_STATS` the same per mesh axis;
:func:`reset_stats` zeroes both.
"""

from __future__ import annotations

import time

import torch

from ..observability import METRICS
from .mesh import active_mesh

#: (backend, collective) pairs the backend refused for CUDA tensors
_STAGED: set[tuple[str, str]] = set()

#: collective -> {"calls", "bytes", "seconds"}, host side
STATS: dict[str, dict] = {}
#: mesh axis -> the same, summed over its collectives
AXIS_STATS: dict[str, dict] = {}


def reset_stats() -> None:
    STATS.clear()
    AXIS_STATS.clear()


def _account(name: str, nbytes: int, t0: float, axis=None) -> None:
    dt = time.perf_counter() - t0
    for table, key in ((STATS, name), (AXIS_STATS, axis)):
        if key is None:
            continue
        st = table.setdefault(key, {"calls": 0, "bytes": 0, "seconds": 0.0})
        st["calls"] += 1
        st["bytes"] += int(nbytes)
        st["seconds"] += dt


def _dist():
    import torch.distributed as dist

    return dist


def _axis(axis: str):
    """(mesh, group, size) of ``axis`` in the active mesh; a rank outside
    the mesh has no part in its collectives and raises."""
    mesh = active_mesh()
    if not mesh.member:
        raise RuntimeError(f"rank {mesh.rank} is not in {mesh}: it has no "
                           "part in the mesh's collectives")
    return mesh, mesh.axis_group(axis), mesh.axis_size(axis)


def _name(dist, base: str):
    """The tensor collective's current name (torch renamed
    ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` to
    ``all_gather_single`` / ``reduce_scatter_single``)."""
    new = {"all_gather": "all_gather_single",
           "reduce_scatter": "reduce_scatter_single"}[base]
    old = {"all_gather": "all_gather_into_tensor",
           "reduce_scatter": "reduce_scatter_tensor"}[base]
    return getattr(dist, new, None) or getattr(dist, old)


def _run(name: str, fn, out: torch.Tensor, inp: torch.Tensor, group,
         axis=None):
    """``fn(out, inp, group=group)``, staged through pinned host memory
    where the group's backend refuses CUDA tensors for it."""
    dist = _dist()
    be = str(dist.get_backend(group))
    key = (be, name)
    t0 = time.perf_counter()
    nbytes = inp.numel() * inp.element_size()
    if inp.is_cuda and key in _STAGED:
        out = _staged(name, fn, out, inp, group)
        _account(name, nbytes, t0, axis)
        return out
    try:
        fn(out, inp, group=group)
    except (RuntimeError, ValueError):
        if not inp.is_cuda or be != "gloo":
            raise
        # gloo checks the device before any byte moves, on every rank
        # alike, so the refusal is symmetric and nothing is half sent
        _STAGED.add(key)
        METRICS.increment("collectives.host_refusals")
        METRICS.gauge(f"collectives.refused.{name}", 1.0)
        out = _staged(name, fn, out, inp, group)
    _account(name, nbytes, t0, axis)
    return out


def _staged(name, fn, out, inp, group):
    host_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
    host_in.copy_(inp)
    host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    fn(host_out, host_in, group=group)
    out.copy_(host_out)
    _count_staged(name)
    return out


def _count_staged(name: str) -> None:
    METRICS.increment("collectives.host_staged")
    METRICS.increment(f"collectives.host_staged.{name}")


def _all_reduce(x: torch.Tensor, group, axis=None) -> torch.Tensor:
    t0 = time.perf_counter()
    out = x.detach().clone()
    _dist().all_reduce(out, group=group)
    _account("all_reduce", out.numel() * out.element_size(), t0, axis)
    return out


def _axes_of(axis) -> tuple[str, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _psum_raw(x, axes) -> torch.Tensor:
    for a in axes:
        _, group, _ = _axis(a)
        if group is not None:
            x = _all_reduce(x, group, a)
    return x


def _size_of(axes) -> int:
    n = 1
    for a in axes:
        n *= _axis(a)[2]
    return n


class _PSum(torch.autograd.Function):
    """psum whose backward is a psum of the cotangent (JAX's transpose
    under ``shard_map(check_vma=False)``); ``mean`` divides both by the
    axes' size (pmean, whose backward is a pmean)."""

    @staticmethod
    def forward(ctx, x, axes, mean):
        ctx.axes, ctx.mean = axes, mean
        out = _psum_raw(x, axes)
        return out / _size_of(axes) if mean else out

    @staticmethod
    def backward(ctx, ct):
        out = _psum_raw(ct, ctx.axes)
        return (out / _size_of(ctx.axes) if ctx.mean else out), None, None


def psum(x, axis):
    """All-reduce sum over a mesh axis (or a tuple of axes)."""
    axes = _axes_of(axis)
    if torch.is_grad_enabled() and x.requires_grad:
        return _PSum.apply(x, axes, False)
    return _psum_raw(x, axes)


def pmean(x, axis):
    """All-reduce mean over a mesh axis (or a tuple of axes)."""
    axes = _axes_of(axis)
    if torch.is_grad_enabled() and x.requires_grad:
        return _PSum.apply(x, axes, True)
    return _psum_raw(x, axes) / _size_of(axes)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _psum_raw(ct, (ctx.axis,)), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _psum_raw(x, (axis,))

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def copy_to_tp(x, axis: str):
    """Enter a tensor-parallel branch: identity forward, psum over
    ``axis`` backward (it collects each shard's cotangent contribution
    once)."""
    return _CopyToTP.apply(x, axis)


def reduce_from_tp(x, axis: str):
    """Leave a tensor-parallel branch: psum over ``axis`` forward (the
    shards' partial sums), identity backward."""
    return _ReduceFromTP.apply(x, axis)


def _gather_tiled(x: torch.Tensor, group, n: int, axis=None) -> torch.Tensor:
    dist = _dist()
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return _run("all_gather", _name(dist, "all_gather"), out, x, group, axis)


def all_gather(x, axis: str, *, tiled: bool = False):
    """The members' tensors stacked on a new leading dim (``tiled``:
    concatenated along dim 0), in axis order."""
    _, group, n = _axis(axis)
    if group is None:
        return x if tiled else x.unsqueeze(0)
    if not tiled:
        return _gather_tiled(x.unsqueeze(0), group, n, axis)
    return _gather_tiled(x, group, n, axis)


def reduce_scatter(x, axis: str, *, scatter_dimension: int = 0):
    """Sum over the axis, each member keeping its contiguous tile of
    ``scatter_dimension`` (whose length the axis size divides)."""
    _, group, n = _axis(axis)
    if group is None:
        return x
    dist = _dist()
    moved = x.movedim(scatter_dimension, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_dimension} of "
                         f"{tuple(x.shape)} does not split over {n} members")
    out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    out = _run("reduce_scatter", _name(dist, "reduce_scatter"), out, moved,
               group, axis)
    return out.movedim(0, scatter_dimension)


# --------------------------------------------------------------- ZeRO helpers
#
# The sharded weight update communicates flattened 1-D gradient/param
# chunks.  On a one-member dp axis the tiled collectives degenerate, so
# these take the axis size explicitly and fall back to psum / identity.

def reduce_scatter_or_psum(x, axis: str, axis_size: int):
    """Reduce-scatter ``x`` (1-D, length divisible by ``axis_size``) into
    per-member contiguous tiles; psum fallback with one member."""
    if axis_size == 1:
        return psum(x, axis)
    return reduce_scatter(x, axis, scatter_dimension=0)


def all_gather_or_identity(x, axis: str, axis_size: int):
    """Tiled all-gather of per-member chunks back to the full flattened
    vector; identity with one member."""
    if axis_size == 1:
        return x
    return all_gather(x, axis, tiled=True)


def _ppermute_raw(x, axis: str, perm) -> torch.Tensor:
    mesh, group, n = _axis(axis)
    if n == 1:
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    dist = _dist()
    t0 = time.perf_counter()
    me = mesh.axis_index(axis)
    ranks = mesh.axis_ranks(axis)
    src = x.detach().contiguous()
    out = torch.zeros_like(src)
    # gloo's point-to-point sends take host tensors only: a CUDA tensor
    # goes through pinned host memory, on every rank of the line alike
    staged = src.is_cuda and str(dist.get_backend(group)) == "gloo"
    if staged:
        send = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        send.copy_(src)
        recv = torch.zeros(src.shape, dtype=src.dtype, pin_memory=True)
    else:
        send, recv = src, out
    ops = []
    for s, d in perm:
        if s == me:
            ops.append(dist.P2POp(dist.isend, send, ranks[d], group=group))
        if d == me:
            ops.append(dist.P2POp(dist.irecv, recv, ranks[s], group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged:
        out.copy_(recv)
        _count_staged("ppermute")
    _account("ppermute", src.numel() * src.element_size(), t0, axis)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _ppermute_raw(x, axis, perm)

    @staticmethod
    def backward(ctx, ct):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute_raw(ct, ctx.axis, inverse), None, None


def ppermute(x, axis: str, perm):
    """Send to and receive from neighbours: ``perm`` lists ``(source,
    destination)`` axis indices; a member no pair sends to gets zeros.
    Its backward sends the cotangent the other way."""
    perm = [(int(s), int(d)) for s, d in perm]
    if torch.is_grad_enabled() and x.requires_grad:
        return _PPermute.apply(x, axis, perm)
    return _ppermute_raw(x, axis, perm)


def ring_shift(x, axis: str, axis_size: int, shift: int = 1):
    """Shift values around the ring by ``shift`` positions."""
    perm = [(i, (i + shift) % axis_size) for i in range(axis_size)]
    return ppermute(x, axis, perm)


def axis_index(axis: str) -> int:
    """This rank's coordinate along ``axis`` of the active mesh."""
    return active_mesh().axis_index(axis)


def collective_device(mesh=None) -> torch.device:
    """Where a collective's own scalars live: the current CUDA device
    under NCCL, else the host."""
    mesh = mesh or active_mesh()
    dist = _dist()
    if mesh.group is not None and str(dist.get_backend(mesh.group)) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier_sum(axis):
    """Cheap cross-member barrier: psum of a scalar 1 (control-plane
    sync)."""
    return psum(torch.ones((), device=collective_device()), axis)
