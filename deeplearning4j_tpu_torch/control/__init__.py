"""SLO-driven control plane.

Port of ``deeplearning4j_tpu/control/``.  Capacity follows the SLO
(:mod:`.autoscaler`) and overload degrades quality before it degrades
availability (:mod:`.overload`).  Control acts only through the seams
serving exposes: ``PrefixRouter.scale_up`` / ``scale_down``, the pool's
quarantine-preserving drain, ``InferenceEngine.set_speculative`` /
``set_max_new_cap`` / ``set_admission_hook``.  No module here mutates a
hash ring.
"""

from .autoscaler import Autoscaler, AutoscalerConfig, ControlSignals
from .overload import (BrownoutConfig, BrownoutController, OverloadGate,
                       Throttled, TokenBucketAdmission)

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "ControlSignals",
    "BrownoutConfig",
    "BrownoutController",
    "OverloadGate",
    "Throttled",
    "TokenBucketAdmission",
]
