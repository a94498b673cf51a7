"""Online learning loop: serve → capture → fine-tune → hot-reload.

Port of ``deeplearning4j_tpu/online``.  :class:`CaptureStore` persists
served traffic durably (the reference's on-disk format), and
:class:`OnlineLoop` fine-tunes on the replayed captures through the
supervised training stack, publishes manifest-verified checkpoints,
hot-reloads them into live serving at generation-consistent fences, and
rolls back any generation that fails its canary or its SLOs.
"""

from .capture import CaptureStore
from .loop import OnlineConfig, OnlineLoop, RoundReport

__all__ = ["CaptureStore", "OnlineConfig", "OnlineLoop", "RoundReport"]
