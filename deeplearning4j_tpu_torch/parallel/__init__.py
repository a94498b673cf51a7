"""Distributed training over ``torch.distributed``: the data-parallel
compute plane.

- **SPMD compute plane** (``mesh``, ``collectives``, ``zero``,
  ``trainer``): every rank runs the same train step over a dp-only
  :class:`~.mesh.Mesh` of process groups; gradients cross in one
  all-reduce (ZeRO stages 1-3 shard the weight update, hogwild averages
  replicas periodically), and elastic shrink and grow rebuild the mesh
  over the live ranks.
- **checkpoint/resume** (``checkpoint``): params + optimizer state + key
  + data cursor, one on-disk format for every stage and width.

The host control plane (``Driver``, the scaleout waves, the process
runners) and the model-parallel axes come later (``ROADMAP.md`` A10.2,
A10.3).
"""

from .checkpoint import CheckpointCorruptError, CheckpointManager
from .compile_cache import setup_compile_cache
from .mesh import (DP, MeshMismatchError, MeshSpec, elastic_mesh, grow_mesh,
                   local_mesh, make_mesh, shrink_mesh)
from .trainer import DataParallelTrainer, LazyLoss, TrainState

__all__ = [
    "MeshSpec", "local_mesh", "make_mesh",
    "MeshMismatchError", "elastic_mesh", "shrink_mesh", "grow_mesh",
    "DataParallelTrainer", "LazyLoss", "TrainState",
    "CheckpointManager", "CheckpointCorruptError", "DP",
    "setup_compile_cache",
]
