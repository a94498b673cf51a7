"""On the card: a harness range around the registered attention kernel
gets that kernel's device time from the profiler, and the share of its
roofline it gives lies in (0, 100].  Skips without a card.

    python -m pytest h100bench -q -m cuda
"""

import pytest
import torch

from h100bench.core import manifest, peaks
from h100bench.core.trace import OpRanges, Profiled

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def test_range_time_and_share(dev):
    from types import SimpleNamespace

    from h100bench.core.roofline import share_pct

    m = manifest.load_metric("attention_fwd_roofline")
    ranges = OpRanges()
    ctx = SimpleNamespace(settings={"attention": "flash"}, ranges=ranges,
                          peaks=peaks.for_card(torch.cuda.get_device_name(0)),
                          traced=None)
    m.install(ctx)
    from deeplearning4j_tpu_torch.ops.cuda import registry

    attend = registry.get("attention", "flash").fn
    q = torch.randn((16, 512, 12, 64), device=dev, dtype=torch.bfloat16)
    attend(q, q, q, causal=False)
    with Profiled(ranges) as p:
        for _ in range(4):
            attend(q, q, q, causal=False)
    ctx.traced = p.result
    assert p.result.op_range_count["attention_fwd"] == 4
    assert p.result.op_device_s["attention_fwd"] > 0
    assert p.result.busy_s > 0
    share = share_pct(ctx, "attention_fwd", m.work)
    assert 0 < share <= 100
