"""Distributed training over ``torch.distributed``.

- **SPMD compute plane** (``mesh``, ``collectives``, ``zero``,
  ``trainer``): every rank runs the same train step over a
  :class:`~.mesh.Mesh` of process groups, one per axis line (pp, dp, sp,
  tp, ep); gradients cross in one all-reduce a replication axis (ZeRO
  stages 1-3 shard the weight update, hogwild averages replicas
  periodically), and elastic shrink and grow rebuild a dp mesh over the
  live ranks.  The model-parallel axes live in the models that use them
  (``models.transformer`` for tp/sp, ``models.pipeline`` for pp,
  ``text.sharded_embedding`` for ep); ``dryrun`` drives them all.
- **checkpoint/resume** (``checkpoint``): params + optimizer state + key
  + data cursor, one on-disk format for every stage, width and mesh.
- **host control plane**: ``Driver`` (``driver``), the single-controller
  entry point over the mesh, the trainer, checkpoints, the supervisor and
  the status server; the scaleout SPI (``scaleout``: jobs, performers,
  ``StateTracker``, the iterative-reduce and hogwild routers,
  ``DistributedRunner`` with heartbeats, eviction, re-routing, respawn and
  the elastic wave), its file state plane (``procstate``) and OS-process
  workers (``procrunner``, ``worker_main``), example performers
  (``performers``), artifact storage and the config registry
  (``storage``), and the cluster bring-up commands (``provision``).
"""

from .checkpoint import CheckpointCorruptError, CheckpointManager
from .compile_cache import setup_compile_cache
from .mesh import (DP, MeshMismatchError, MeshSpec, elastic_mesh, grow_mesh,
                   local_mesh, make_mesh, shrink_mesh)
from .trainer import DataParallelTrainer, LazyLoss, TrainState
from .driver import Driver

__all__ = [
    "MeshSpec", "local_mesh", "make_mesh",
    "MeshMismatchError", "elastic_mesh", "shrink_mesh", "grow_mesh",
    "DataParallelTrainer", "LazyLoss", "TrainState",
    "CheckpointManager", "CheckpointCorruptError", "DP", "Driver",
    "setup_compile_cache",
]
