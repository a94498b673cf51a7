"""attention_bwd_ms: the device time of the attention backwards of the LM
train step (``_Attention.backward``, one ``kernel.attention.backward``
span a layer: the blockwise recompute in f32 torch ops), in ms a step of
the window (``train_fwd_ms.per_step_ms`` says how).
"""

from h100bench.core.manifest import load_metric

SPANS = ("kernel.attention.backward",)


def read(ctx):
    return load_metric("train_fwd_ms").per_step_ms(ctx, SPANS)
