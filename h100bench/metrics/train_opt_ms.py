"""train_opt_ms: the device time of the LM train step's optimizer (the
transform and ``apply_updates``, the ``lm.optimizer`` span), in ms a step
of the window (``train_fwd_ms.per_step_ms`` says how).
"""

from h100bench.core.manifest import load_metric

SPANS = ("lm.optimizer",)


def read(ctx):
    return load_metric("train_fwd_ms").per_step_ms(ctx, SPANS)
