"""Training on one device: the data-parallel trainer's async hot loop and
checkpoint/resume with integrity verification.

Meshes, collectives, ZeRO stages 1-3, hogwild and elastic resize come
with the multi-device port (``ROADMAP.md`` A10).
"""

from .checkpoint import CheckpointCorruptError, CheckpointManager
from .mesh import DP, MeshMismatchError
from .trainer import DataParallelTrainer, LazyLoss, TrainState

__all__ = ["CheckpointCorruptError", "CheckpointManager", "DP",
           "DataParallelTrainer", "LazyLoss", "MeshMismatchError",
           "TrainState"]
