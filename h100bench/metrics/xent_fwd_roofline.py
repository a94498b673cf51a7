"""xent_fwd_roofline: the LM loss forward's share of its roofline.

Work of one call, hiddens h (N, D), head (D, V), targets (N,): the
logits' 2 x N x D x V flops, h, the head and the targets read once and
the summed loss written.  Time: the device time of the kernels launched
inside a range the harness puts around the blocked token cross entropy
the loss calls (``ops.losses.blocked_token_xent``).
"""

from h100bench.core.roofline import share_pct
from h100bench.core.trace import wrap_attr

OP = "xent_fwd"


def record(h, head, targets, *args, **kw):
    return {"h": tuple(h.shape), "V": head.shape[-1],
            "bytes": (h.numel() * h.element_size()
                      + head.numel() * head.element_size()
                      + targets.numel() * targets.element_size() + 4),
            "dtype": str(h.dtype).split(".")[-1]}


def work(call: dict) -> tuple:
    N, D = call["h"]
    return 2 * N * D * call["V"], call["bytes"], call["dtype"]


def install(ctx):
    from deeplearning4j_tpu_torch.ops import losses

    wrap_attr(losses, "blocked_token_xent", ctx.ranges, OP, record)


def read(ctx):
    return share_pct(ctx, OP, work)
