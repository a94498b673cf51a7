"""train_bwd_ms: the device time of the LM train step's backward
(``torch.autograd.grad``, the ``lm.backward`` span; under remat the
blocks' second forward runs inside it), in ms a step of the window
(``train_fwd_ms.per_step_ms`` says how).
"""

from h100bench.core.manifest import load_metric

SPANS = ("lm.backward",)


def read(ctx):
    return load_metric("train_fwd_ms").per_step_ms(ctx, SPANS)
