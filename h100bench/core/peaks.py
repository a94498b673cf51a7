"""Published peaks of the cards the benchmark runs on, and the least time
of a piece of work on them.

NVIDIA's data sheets, dense rates without sparsity, at the card's full
power limit: the H100 SXM at 989 TFLOP/s in bf16 and fp16, 67 TFLOP/s in
float32 outside the tensor cores, 495 TFLOP/s in TF32, and 3.35 TB/s of
HBM3.  A card set below its maximum power limit runs slower under load,
so every result carries the limit beside these peaks.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    bf16_flops: float       # dense tensor-core rate, bf16/fp16 operands
    tf32_flops: float
    f32_flops: float        # float32 outside the tensor cores
    bytes_per_s: float      # device memory bandwidth


#: by a fragment of ``torch.cuda.get_device_name()``, most specific first
TABLE = (
    ("H100 PCIe", Peaks(756e12, 378e12, 51e12, 2.0e12)),
    ("H100 NVL", Peaks(835e12, 418e12, 60e12, 3.9e12)),
    ("H100", Peaks(989e12, 495e12, 67e12, 3.35e12)),
)

#: the peaks a CPU rehearsal computes its shares against: the H100 SXM's,
#: so the arithmetic runs; no CPU number is ever reported as a device one
REHEARSAL = TABLE[-1][1]


def for_card(name: str) -> Peaks:
    for frag, peaks in TABLE:
        if frag in name:
            return peaks
    raise SystemExit(f"h100bench: no published peaks for card {name!r}")


def matmul_flops_rate(peaks: Peaks, dtype_name: str) -> float:
    """The rate a product with operands of ``dtype_name`` can reach."""
    if dtype_name in ("bfloat16", "float16"):
        return peaks.bf16_flops
    return peaks.f32_flops


def least_time_s(flops: float, nbytes: float, flops_rate: float,
                 peaks: Peaks) -> float:
    """The least time the card could take: the larger of the work over the
    compute peak and the bytes over the memory peak."""
    return max(flops / flops_rate, nbytes / peaks.bytes_per_s)
