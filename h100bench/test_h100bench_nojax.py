"""No module a run loads is JAX's or the JAX package's: after a CPU
rehearsal of each cell, in a fresh interpreter, every loaded module's
top-level name (the part before the first dot) is compared whole with
``jax``, ``jaxlib``, ``flax`` and ``deeplearning4j_tpu``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from h100bench.tools import rehearse
res = rehearse.rehearse({workload!r}, 2 ** 31 + 5, 1.0, {trace})
sys.path.insert(0, {root!r} + "/h100bench")
import run
print(json.dumps({{"tops": sorted({{m.split(".", 1)[0] for m in sys.modules}}),
                  "forbidden": run.forbidden_modules(),
                  "correct": res["correct"]}}))
"""


@pytest.mark.parametrize("workload,trace", [
    ("bert-base.train-64x512", True), ("gpt2-small.train-64x1024", False),
    ("gpt2-small.serve-int8-decode32", True)])
def test_a_rehearsal_loads_no_jax(workload, trace):
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(ROOT),
                                             workload=workload,
                                             trace=trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "deeplearning4j_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "deeplearning4j_tpu"} & set(
        got["tops"])
    assert got["correct"]


def test_the_check_compares_whole_top_level_names():
    sys.path.insert(0, str(ROOT / "h100bench"))
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["deeplearning4j_tpu_torch_x"] = sys
        sys.modules["jaxfoo.bar"] = sys
        assert run.forbidden_modules() == []
        sys.modules["deeplearning4j_tpu.ops"] = sys
        assert run.forbidden_modules() == ["deeplearning4j_tpu"]
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
