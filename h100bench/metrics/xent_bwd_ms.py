"""xent_bwd_ms: the device time of the LM loss's backward
(``_BlockedXent.backward``, the ``kernel.xent.backward`` span: each token
tile's logits recomputed, then the hidden and head gradients, in f32
torch ops), in ms a step of the window (``train_fwd_ms.per_step_ms`` says
how).
"""

from h100bench.core.manifest import load_metric

SPANS = ("kernel.xent.backward",)


def read(ctx):
    return load_metric("train_fwd_ms").per_step_ms(ctx, SPANS)
