"""layernorm_bwd_ms: the device time of the fused residual LayerNorm
backwards of the LM train step (``_ResidualLayerNorm.backward``, one
``kernel.layernorm.backward`` span a layer), in ms a step of the window
(``train_fwd_ms.per_step_ms`` says how).
"""

from h100bench.core.manifest import load_metric

SPANS = ("kernel.layernorm.backward",)


def read(ctx):
    return load_metric("train_fwd_ms").per_step_ms(ctx, SPANS)
