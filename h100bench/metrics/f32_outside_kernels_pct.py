"""f32_outside_kernels_pct: the share of the train step's device busy
time spent outside the port's kernels and the tensor-core GEMMs: float32
GEMMs (the attention and xent backwards) and elementwise work,
reductions and copies.  Kernels are classed by their names as the
profiler reports them (a frozen copy of ``chip_smoke.py::kernel_class``).
"""

#: symbols of the port's own training kernels, as the profiler names them
PORT_KERNEL_SYMBOLS = ("flash_fwd_kernel", "flash_fwd_f32_kernel",
                       "xent_tiles_kernel", "xent_tiles_f32_kernel",
                       "xent_merge_kernel", "residual_layernorm_kernel")


def kernel_class(name: str) -> str:
    if any(sym in name for sym in PORT_KERNEL_SYMBOLS):
        return "port kernels"
    low = name.lower()
    if "sgemm" in low or "f32f32_f32f32" in low:
        return "f32 GEMM"
    # cuBLAS names its Hopper tensor-core GEMMs nvjet_*
    if "gemm" in low or low.startswith("nvjet"):
        return "tensor-core GEMM"
    return "elementwise, reductions, copies"


def read(ctx):
    t = ctx.traced
    if t is None or not t.by_name_s:
        return None
    total = sum(t.by_name_s.values())
    outside = sum(s for n, s in t.by_name_s.items()
                  if kernel_class(n) in ("f32 GEMM",
                                         "elementwise, reductions, copies"))
    return 100.0 * outside / total if total > 0 else None
