"""Device meshes over ``torch.distributed`` process groups, and the
multi-process bootstrap.

Port of ``deeplearning4j_tpu/parallel/mesh.py``.  The reference is one
controller over a ``jax.sharding.Mesh`` of devices; the port is SPMD over
processes: every rank runs the same program, and a device of the
reference is a rank here (:class:`RankDevice`, whose ``id`` is the global
rank).  :func:`rank_devices` is the counterpart of ``jax.devices()``: the
world's ranks, in order.

A :class:`Mesh` names the axes of an array of rank devices, in the
reference's order (pp, dp, sp, tp, ep), and holds one process group per
axis LINE: the ranks that differ only in that axis's coordinate (a rank's
``tp`` group is its tensor-parallel peers, its ``pp`` group its pipeline
stages).  Creating a group is collective over the WORLD
(``torch.distributed.new_group``), so every rank, member or not, builds
every mesh, in the same order, and a mesh builds its lines' groups axis
by axis, line by line.  That is also the elastic design: the world is
the device pool, ``shrink_mesh`` builds a group over the survivors, the
lost ranks stay alive and outside it, and ``grow_mesh`` builds one that
takes them back (elasticity is dp-only, as in the reference).  A rank
outside a mesh holds a mesh it is not a ``member`` of, and code over
that mesh skips its work there.

Without an initialized process group the world is this one process:
``rank_devices()`` is ``[RankDevice(0)]`` and every collective over a
one-member axis is the identity, so the one-device paths need no
bootstrap.  :func:`initialize_multihost` initializes the group from the
usual environment (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``) or explicit arguments, as ``jax.distributed.initialize``
does for the reference.  NCCL is refused for two ranks on one GPU (it
cannot run them); gloo is the transport there, and the collectives say
when they stage a CUDA tensor through host memory.

:class:`PartitionSpec` (``P``) and :class:`NamedSharding` keep the
reference's placement vocabulary: a dim named by a mesh axis is split
over that axis's ranks in contiguous blocks, and :func:`local_block`
takes this rank's block of a global tensor (the rank-level
``device_put``); a dim may name a tuple of axes, split with the first
axis major, as JAX's.  :func:`global_block` is the inverse: the ranks
all-gather their blocks into the global tensor.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import socket
from typing import Sequence

import numpy as np

DP, TP, PP, SP, EP = "dp", "tp", "pp", "sp", "ep"

#: the axis names every spec and collective draws from
AXES: tuple[str, ...] = (DP, TP, PP, SP, EP)

#: role of each axis, for error messages and operator docs
AXIS_ROLES: dict[str, str] = {
    DP: "data",
    TP: "tensor/model",
    PP: "pipeline stages",
    SP: "sequence (ring attention / context parallel)",
    EP: "expert",
}

#: seconds a collective may wait before the process group gives up (a
#: hung peer fails the run instead of holding it)
DEFAULT_TIMEOUT_S = float(os.environ.get("DL4J_TORCH_DIST_TIMEOUT_S", 600))


class MeshMismatchError(RuntimeError):
    """A checkpoint written at one dp width met a trainer of another width
    without ``reshard=True`` (or with shapes that no reshard can explain).

    Carries both widths and the zero stage, so the operator can tell at a
    glance whether to pass ``reshard=True`` or fix the topology."""

    def __init__(self, saved_dp, restore_dp, zero_stage, detail: str = ""):
        self.saved_dp = saved_dp
        self.restore_dp = restore_dp
        self.zero_stage = zero_stage
        msg = (f"checkpoint written at dp={saved_dp} cannot restore onto "
               f"dp={restore_dp} (zero_stage={zero_stage}) without "
               f"reshard=True")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


# ------------------------------------------------------------------ ranks

@dataclasses.dataclass(frozen=True)
class RankDevice:
    """One rank of the world, in the role of one device of the reference's
    mesh (``id`` is the global rank, as a JAX device's ``id``)."""

    id: int

    def __repr__(self) -> str:
        return f"rank{self.id}"


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world_rank() -> int:
    """This process's global rank (0 without a process group)."""
    dist = _dist()
    return dist.get_rank() if dist else 0


def world_size() -> int:
    """Ranks in the world (1 without a process group)."""
    dist = _dist()
    return dist.get_world_size() if dist else 1


def rank_devices() -> list[RankDevice]:
    """The world's ranks as devices, in rank order (``jax.devices()``)."""
    return [RankDevice(r) for r in range(world_size())]


def backend() -> str | None:
    """The world group's backend (``"gloo"``, ``"nccl"``), or None."""
    dist = _dist()
    return str(dist.get_backend()) if dist else None


# ------------------------------------------------------------------ specs

class PartitionSpec:
    """Per-dim mesh axis names (None: replicated), as JAX's ``P``.  Not a
    tuple, so the tree walks of ``utils.tree_math`` take it as a leaf."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and other.axes == self.axes

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"P{self.axes!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement of a tensor over a mesh: each dim named by ``spec`` is
    split in contiguous blocks over that axis's ranks."""

    mesh: "Mesh"
    spec: PartitionSpec


# ------------------------------------------------------------------ meshes

#: process groups by member ranks: a mesh over ranks that an earlier mesh
#: covered reuses its group (every rank makes the same choice)
_GROUPS: dict[tuple[int, ...], object] = {}


def _group_for(ranks: tuple[int, ...]):
    """The process group over ``ranks`` (collective over the world the
    first time: every rank must ask for the same groups in one order)."""
    dist = _dist()
    if dist is None:
        if ranks != (0,):
            raise RuntimeError(
                f"a mesh over ranks {list(ranks)} needs an initialized "
                "process group (parallel.mesh.initialize_multihost)")
        return None
    if ranks == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


class Mesh:
    """Named axes over an array of rank devices, with a process group per
    axis line.

    ``devices`` has the mesh's shape; ``shape`` maps each axis to its
    size, as the reference's ``mesh.shape``; ``devices.size`` is the
    mesh's rank count.  ``member`` says whether this process is one of the
    mesh's ranks.  ``group`` is the group over all the mesh's ranks.
    ``with mesh:`` makes it the mesh the collectives' axis names refer
    to."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            d = np.asarray(devices, dtype=object)[idx]
            arr[idx] = d if isinstance(d, RankDevice) else RankDevice(int(d))
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != arr.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{arr.ndim}-d device array")
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.ranks = tuple(d.id for d in arr.flat)
        if len(set(self.ranks)) != len(self.ranks):
            raise ValueError(f"a rank appears twice in the mesh {self.ranks}")
        self.rank = world_rank()
        self.member = self.rank in self.ranks
        self.group = _group_for(tuple(sorted(self.ranks)))
        ids = np.array(self.ranks, dtype=np.int64).reshape(arr.shape)
        # per axis: this rank's line (its peers along the axis, ordered
        # by global rank, as a process group orders its members) and the
        # line's group; every line's group is created on every rank, in
        # one order.  A one-wide axis has no group (its collectives are
        # the identity), except dp on a mesh whose other axes are all one
        # wide: its group is the mesh's, so a one-rank data-parallel mesh
        # in a process group still runs its collectives through the
        # backend
        only_dp = all(n == 1 for a, n in self.shape.items() if a != DP)
        self._lines: dict[str, tuple[int, ...]] = {}
        self._groups: dict[str, object] = {}
        for k, axis in enumerate(self.axis_names):
            lines = np.moveaxis(ids, k, -1).reshape(-1, arr.shape[k])
            for line in lines:
                line = tuple(sorted(int(r) for r in line))
                mine = self.rank in line
                if mine:
                    self._lines[axis] = line
                if axis == DP and only_dp:
                    if mine:
                        self._groups[axis] = self.group
                elif len(line) > 1:
                    g = _group_for(line)
                    if mine:
                        self._groups[axis] = g

    # -- axes ------------------------------------------------------------
    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 off the mesh)."""
        if not self.member or self.axis_size(axis) == 1:
            return 0
        return self._lines[axis].index(self.rank)

    def axis_group(self, axis: str):
        """The process group of this rank's line along ``axis``; None for a
        one-wide axis (but dp's on a dp-only mesh: the mesh's group) and
        without a process group."""
        return self._groups.get(axis)

    def axis_ranks(self, axis: str) -> tuple[int, ...]:
        """The global ranks of this rank's line along ``axis``, by
        coordinate."""
        return self._lines.get(axis, (self.rank,)) \
            if self.axis_size(axis) > 1 else (self.rank,)

    # -- the active mesh -------------------------------------------------
    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.pop()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={list(self.ranks)})"


_ACTIVE: list[Mesh] = []


def active_mesh() -> Mesh:
    """The innermost ``with mesh:`` (what the collectives' axis names
    refer to); raises outside one."""
    if not _ACTIVE:
        raise RuntimeError("no active mesh: call collectives inside "
                           "`with mesh:`")
    return _ACTIVE[-1]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named mesh shape; -1 on one axis means 'absorb remaining devices'."""

    dp: int = -1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {DP: self.dp, TP: self.tp, PP: self.pp, SP: self.sp, EP: self.ep}
        wild = [k for k, v in sizes.items() if v == -1]
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by {fixed}")
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(f"mesh {sizes} != {n_devices} devices")
        return sizes


def make_mesh(spec: MeshSpec | None = None,
              devices: Sequence | None = None) -> Mesh:
    """A named mesh over the given (default: all) rank devices, axis order
    (pp, dp, sp, tp, ep) as the reference's."""
    spec = spec or MeshSpec()
    devices = list(devices if devices is not None else rank_devices())
    sizes = spec.resolve(len(devices))
    order = (PP, DP, SP, TP, EP)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(sizes[a] for a in order)), order)


def local_mesh(n: int | None = None, axis: str = DP) -> Mesh:
    """1-axis mesh over the world's ranks (the common data-parallel case)."""
    devices = rank_devices()
    return _one_axis(devices[: (n or len(devices))], axis)


def _one_axis(devices, axis: str) -> Mesh:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return Mesh(arr, (axis,))


def mesh_devices(mesh: Mesh) -> list:
    """Flat device list of a mesh, in axis order."""
    return list(mesh.devices.flat)


def dp_width(mesh: Mesh) -> int:
    """Data-parallel width of a mesh (1 when it has no dp axis)."""
    return int(mesh.shape.get(DP, 1))


def elastic_mesh(devices: Sequence, axis: str = DP) -> Mesh:
    """1-axis mesh over an explicit device list — the topology-change
    primitive every shrink/grow rebuild goes through."""
    devices = list(devices)
    if not devices:
        raise ValueError("elastic_mesh: no surviving devices")
    return _one_axis(devices, axis)


def _dev_id(d):
    return getattr(d, "id", d)


def shrink_mesh(mesh: Mesh, lost: Sequence) -> Mesh:
    """Rebuild a dp mesh from the survivors after losing ``lost`` ranks
    (they stay in the world, outside the new mesh)."""
    if any(n != 1 for a, n in mesh.shape.items() if a != DP):
        raise ValueError(f"shrink_mesh: only dp meshes are elastic, got "
                         f"{mesh.shape}")
    lost_ids = {_dev_id(d) for d in lost}
    survivors = [d for d in mesh_devices(mesh) if d.id not in lost_ids]
    if len(survivors) == len(mesh_devices(mesh)):
        raise ValueError("shrink_mesh: no listed device is in the mesh")
    return elastic_mesh(survivors)


def grow_mesh(mesh: Mesh, regained: Sequence) -> Mesh:
    """Rebuild a dp mesh with ``regained`` ranks appended (ranks already
    present are ignored, so re-registration is idempotent)."""
    current = mesh_devices(mesh)
    have = {d.id for d in current}
    added = [d if isinstance(d, RankDevice) else RankDevice(int(d))
             for d in regained if _dev_id(d) not in have]
    return elastic_mesh(current + added)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, axis: str = DP, ndim: int = 2) -> NamedSharding:
    """Split the leading (batch) dim over ``axis``, replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def _dim_axes(entry) -> tuple[str, ...]:
    """The axes a spec entry names: None, one axis or a tuple of axes."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _split(mesh: "Mesh", axes: tuple[str, ...]) -> tuple[int, int]:
    """(block count, this rank's block index) of a dim split over ``axes``
    (the first axis major)."""
    n, i = 1, 0
    for axis in axes:
        n, i = n * mesh.axis_size(axis), i * mesh.axis_size(axis) \
            + mesh.axis_index(axis)
    return n, i


def local_block(x, sharding: NamedSharding):
    """This rank's block of the global tensor or array ``x`` under
    ``sharding``: each dim named by an axis (or a tuple of axes, the first
    major) is split into equal contiguous blocks; a replicated spec gives
    ``x``; trailing ``None`` dims past ``x``'s rank are ignored.  A rank
    outside the mesh gets ``x`` unsplit."""
    mesh = sharding.mesh
    if not mesh.member:
        return x
    for dim, entry in enumerate(sharding.spec):
        n, i = _split(mesh, _dim_axes(entry))
        if n == 1:
            continue
        if dim >= x.ndim:
            raise ValueError(f"spec {sharding.spec} splits dim {dim} of a "
                             f"{x.ndim}-d array")
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not "
                             f"split over {n} ranks of {entry!r}")
        k = x.shape[dim] // n
        index = [slice(None)] * x.ndim
        index[dim] = slice(i * k, (i + 1) * k)
        x = x[tuple(index)]
    return x


def global_shape(shape, sharding: NamedSharding) -> tuple[int, ...]:
    """The global shape of a block of ``shape`` placed by ``sharding``."""
    mesh = sharding.mesh
    out = list(shape)
    for dim, entry in enumerate(sharding.spec):
        if dim < len(out):
            out[dim] *= _split(mesh, _dim_axes(entry))[0]
    return tuple(out)


def global_block(x, sharding: NamedSharding):
    """The inverse of :func:`local_block`: every member's block of a
    tensor placed by ``sharding``, all-gathered into the global tensor
    (collective over the axes the spec names, innermost axis first, in
    one order on every rank).  A rank outside the mesh gets ``x``."""
    from . import collectives as clv

    mesh = sharding.mesh
    if not mesh.member:
        return x
    with mesh:
        for dim, entry in enumerate(sharding.spec):
            for axis in reversed(_dim_axes(entry)):
                if mesh.axis_size(axis) == 1:
                    continue
                moved = x.movedim(dim, 0).contiguous()
                x = clv.all_gather(moved, axis, tiled=True).movedim(0, dim)
    return x


# ------------------------------------------------------------------ bootstrap

def _check_nccl_devices(dist) -> None:
    """NCCL cannot run two ranks on one GPU: fail with both ranks named
    (over a gloo side group, since NCCL itself would fail obscurely)."""
    import torch

    probe = dist.new_group(backend="gloo")
    me = (socket.gethostname(), torch.cuda.current_device())
    seen: list = [None] * dist.get_world_size()
    dist.all_gather_object(seen, me, group=probe)
    dist.destroy_process_group(probe)
    by_gpu: dict = {}
    for r, key in enumerate(seen):
        by_gpu.setdefault(tuple(key), []).append(r)
    shared = {f"{h}:cuda:{i}": rs for (h, i), rs in by_gpu.items()
              if len(rs) > 1}
    if shared:
        dist.destroy_process_group()
        raise RuntimeError(
            f"NCCL cannot run several ranks on one GPU ({shared}): give each "
            "rank its own card (torch.cuda.set_device) or initialize with "
            "backend='gloo'")


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str | None = None,
                         timeout_s: float | None = None) -> None:
    """Join the process group (``jax.distributed.initialize``'s place).

    No-op when no coordinator is given or set.  ``coordinator`` is
    ``host:port`` (a TCP rendezvous), a ``tcp://`` or ``file://`` URL;
    else ``MASTER_ADDR``/``MASTER_PORT`` with ``RANK`` and
    ``WORLD_SIZE`` from the environment, as ``torchrun`` sets them.
    ``backend`` defaults to NCCL when CUDA is available, else gloo; NCCL
    with two ranks on one GPU raises.  ``timeout_s`` bounds every
    collective's wait."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = "env://"
    if not coordinator:
        return
    if "://" not in coordinator:
        coordinator = "tcp://" + coordinator
    kw = {}
    if coordinator != "env://" or num_processes is not None:
        kw["world_size"] = int(num_processes if num_processes is not None
                               else os.environ.get("WORLD_SIZE", 1))
    if coordinator != "env://" or process_id is not None:
        kw["rank"] = int(process_id if process_id is not None
                         else os.environ.get("RANK", 0))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(
        backend, init_method=coordinator,
        timeout=datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S),
        **kw)
    if backend == "nccl":
        _check_nccl_devices(dist)


def shutdown_multihost() -> None:
    """Leave the process group (and forget the cached sub-groups)."""
    dist = _dist()
    _GROUPS.clear()
    if dist is not None:
        dist.destroy_process_group()
