"""The port's multi-rank sharding dryrun and its CLI.

``mesh_spec_for`` factors a rank count as the reference's does, for every
n from 1 to 16.  ``python -m deeplearning4j_tpu_torch dryrun --devices 8
--platform cpu`` spawns eight gloo ranks (one spawn for the module) that
run the reference's three legs — the step on dp2·pp2·tp2 (the GPipe
pipeline with tp inside its stages), ZeRO-1 on it, and the ring with pp
folded into sp — and prints the reference's ``dryrun_multichip OK`` line
with the same mesh, batch, sequence and micro-batch counts.  The losses
differ from the reference's: its tokens and weights come from JAX keys.
``--devices 16`` spawns sixteen ranks over all four axes, dp2·pp2·tp2·sp2,
the mesh of the reference's ``tests/test_dryrun_all_axes.py``.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

from deeplearning4j_tpu.parallel.dryrun import mesh_spec_for as jspec_for
from deeplearning4j_tpu_torch.parallel.dryrun import mesh_spec_for

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_spec_for_matches_the_reference(n):
    got, want = mesh_spec_for(n), jspec_for(n)
    assert (got.dp, got.tp, got.pp, got.sp, got.ep) == (
        want.dp, want.tp, want.pp, want.sp, want.ep)
    assert got.resolve(n) == want.resolve(n)


def test_dryrun_cli_runs_eight_ranks_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "dryrun",
         "--devices", "8", "--platform", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun_multichip OK: ")]
    assert len(lines) == 1, proc.stdout
    line = lines[0]
    assert ("mesh={'dp': 2, 'tp': 2, 'pp': 2, 'sp': 1, 'ep': 1} devices=8 "
            "batch=8 seq=8 n_micro=4 loss=") in line
    assert re.search(r"zero1\[pp-pipelined,dp2\]_loss=\d+\.\d{4}", line)
    assert re.search(r"ring\[dp2·tp2·sp2\]_loss=\d+\.\d{4}$", line)


def test_dryrun_cli_runs_sixteen_ranks_over_all_four_axes():
    """The reference's 16-device dryrun (``tests/test_dryrun_all_axes.py``)
    on sixteen gloo ranks: the factoring uses dp, tp, pp and sp at 2 each,
    and the pipelined step runs with ZeRO-1 on it (~20 s alone)."""
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "dryrun",
         "--devices", "16", "--platform", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun_multichip OK: ")]
    assert len(lines) == 1, proc.stdout
    want = jspec_for(16).resolve(16)
    assert want == {"dp": 2, "tp": 2, "pp": 2, "sp": 2, "ep": 1}
    assert f"mesh={want} devices=16 " in lines[0]
    for axis in ("'dp': 2", "'tp': 2", "'pp': 2", "'sp': 2"):
        assert axis in lines[0]
    assert re.search(r"zero1\[pp-pipelined,dp2\]_loss=\d+\.\d{4}$",
                     lines[0])


def test_dryrun_fails_without_enough_ranks():
    """Without a process group the world is one rank: an 8-rank dryrun
    in this process raises instead of running on fewer."""
    from deeplearning4j_tpu_torch.parallel.dryrun import dryrun_multichip

    with pytest.raises(RuntimeError, match="need 8 ranks"):
        dryrun_multichip(8, device="cpu")
