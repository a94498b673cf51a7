"""Mesh axis names and the topology error of the checkpoint restore.

The part of ``deeplearning4j_tpu/parallel/mesh.py`` that one device needs:
the data-parallel axis name :data:`DP` (the key under which a checkpoint's
``meta.json`` stamps its dp width) and :class:`MeshMismatchError`.  Meshes
themselves (``MeshSpec``, ``make_mesh``, elastic shrink and grow) come
with the multi-device port (``ROADMAP.md`` A10).
"""

from __future__ import annotations

DP = "dp"


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
