"""attention_fwd_roofline: the training attention forward's share of its
roofline.

Work of one call at its shapes, q, k, v (B, T, H, Dh): 4 x B x H x Dh
flops over each (query, key) pair the mask keeps (T^2, or T (T + 1) / 2
causal), and q, k, v read and the output written once each.  Time: the
device time of the kernels launched inside a range the harness puts
around the registered attention candidate the step resolves.
"""

from h100bench.core.roofline import share_pct
from h100bench.core.trace import wrap_registered

OP = "attention_fwd"


def record(q, k, v, *args, causal=True, **kw):
    return {"q": tuple(q.shape), "kv": (k.numel(), v.numel()),
            "esize": q.element_size(), "dtype": str(q.dtype).split(".")[-1],
            "causal": bool(causal)}


def work(call: dict) -> tuple:
    B, T, H, Dh = call["q"]
    pairs = T * (T + 1) // 2 if call["causal"] else T * T
    flops = 4 * B * H * Dh * pairs
    nbytes = (2 * B * T * H * Dh + sum(call["kv"])) * call["esize"]
    return flops, nbytes, call["dtype"]


def install(ctx):
    wrap_registered("attention", ctx.settings["attention"], ctx.ranges, OP,
                    record)


def read(ctx):
    return share_pct(ctx, OP, work)
