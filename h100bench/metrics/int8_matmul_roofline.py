"""int8_matmul_roofline: the int8-weight product's share of its roofline,
over every call of the serving loop (prefill rows and decode steps).

Work of one call, x (M, K) times int8 weights (K, N) with N f32 scales:
2 x M x K x N flops; x, the weights and the scales read once and the
f32 output (M, N) written once.  Time: the device time of the kernels
launched inside a range the harness puts around the model's
``int8_matmul``.
"""

from h100bench.core.roofline import share_pct
from h100bench.core.trace import wrap_attr

OP = "int8_matmul"


def record(x, qw, *args, **kw):
    K, N = qw.q.shape
    return {"M": x.numel() // K, "K": K, "N": N, "esize": x.element_size(),
            "dtype": str(x.dtype).split(".")[-1]}


def work(call: dict) -> tuple:
    M, K, N = call["M"], call["K"], call["N"]
    nbytes = M * K * call["esize"] + K * N + 4 * N + 4 * M * N
    return 2 * M * K * N, nbytes, call["dtype"]


def install(ctx):
    from deeplearning4j_tpu_torch.models import transformer

    wrap_attr(transformer, "int8_matmul", ctx.ranges, OP, record)


def read(ctx):
    return share_pct(ctx, OP, work)
