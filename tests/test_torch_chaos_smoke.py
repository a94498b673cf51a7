"""The port's chaos smoke tool against the reference's
(``tools/chaos_smoke.py``), on the CPU.

Same draws: ``_draw_plan`` gives the reference's plan strings for seeds
0-49, and the elastic leg's plan matches.  Same recovery: at pinned
seeds ``run`` (stage 0, and sharded stage 2) gives the reference's
plan, attempts, retries, preemptions, resume points, corruption count,
fault counters and final step, with the port's parameters bitwise those
of its replicated fault-free run.  The reference runs ``dp=8`` on
virtual devices; the port runs 4 spawned gloo ranks (one pool for the
module, reused by every multi-rank test).  Then one fixed-seed run of
each remaining leg, the CLI's dispatch with ``--shardguard``, and its
device rule.
"""

import json
import random
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch.tools import chaos_smoke as cs
from test_torch_serving_smoke import reference_keys
from torch_port_obs import port_obs  # noqa: F401  (autouse)

from tools import chaos_smoke as jcs

REF = Path(__file__).resolve().parents[1] / "tools" / "chaos_smoke.py"
CPU = "cpu"
WORLD = 4
RECOVERY = ("plan", "attempts", "retries", "preemptions", "resumed_from",
            "corrupt_detected", "faults_injected", "final_step")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models: torch's intra-op threads only spin (and slow the
    other test workers); one thread for this module, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", autouse=True)
def rank_pool():
    """The tool's own rank pool, started by the first multi-rank leg and
    closed after the module."""
    yield
    cs.close_ranks()


def test_draw_plan_equals_the_reference_for_fifty_seeds():
    for seed in range(50):
        want = jcs._draw_plan(random.Random(seed))
        got = cs._draw_plan(random.Random(seed))
        assert cs._plan_strings(got) == [
            f"{s.site}:at={s.at_step},kind={s.kind}" for s in want]


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("seed,stage", [(0, 0), (2, 2)])
def test_same_recovery_as_the_reference(seed, stage):
    ref = jcs.run(seed=seed, zero_stage=stage)
    got = cs.run(seed, zero_stage=stage, world=WORLD, device=CPU)
    assert {k: got[k] for k in RECOVERY} == {k: ref[k] for k in RECOVERY}
    assert got["params_bitwise_equal"] and got["loss_parity"]
    assert got["losses_recovered"] == ref["losses_recovered"]
    assert got["goodput"]["fraction"] < got["goodput"]["ref_fraction"]
    assert set(ref) <= set(got) and got["world"] == WORLD


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_elastic_leg():
    got = cs.run_elastic(13, world=WORLD, device=CPU)
    assert got["final_step"] == got["ref_step"]
    assert got["loss_window"] <= 1e-5 and got["mesh_resize_bundles"]
    rng = random.Random(13 + 2)
    stage, lost = rng.choice([0, 1, 2, 3]), rng.randint(1, 3)
    assert got["zero_stage"] == stage and got["mesh_sizes"][0] == WORLD - lost
    assert got["plan"][0].startswith("mesh.shrink:")
    assert reference_keys(REF, "run_elastic") <= set(got)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_serving_leg(kv_quant):
    got = cs.run_serving(0, kv_quant=kv_quant, device=CPU)
    assert got["submit_retries"] == 1 and got["lockguard_violations"] == 0
    assert got["token_agreement_under_faults"] >= 0.999
    assert reference_keys(REF, "run_serving") <= set(got)


def test_disagg_leg():
    got = cs.run_disagg(0, device=CPU)
    assert got["token_parity_under_faults"]
    assert got["leaked_pages"] == {"prefill": (0, 0), "decode": (0, 0)}
    assert reference_keys(REF, "run_disagg") <= set(got)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_online_leg():
    got = cs.run_online(0, device=CPU)
    assert got["rollback_bundles"] and got["rounds"][-1] == "ok"
    assert got["token_parity_at_stamped_generation"]
    assert reference_keys(REF, "run_online") <= set(got)


def test_overload_leg():
    got = cs.run_overload(0, device=CPU)
    assert got["brownout_transitions"] == 6 and got["pool_after_kill"] == 2
    assert reference_keys(REF, "run_overload") <= set(got)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_cli_replays_a_stage_under_shardguard(capsys):
    assert cs.main(["--platform", "cpu", "--seed", "1", "--stage", "1",
                    "--world", str(WORLD), "--shardguard"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["zero_stage"] == 1 and line["shardguard_violations"] == 0
    assert line["plan"] == [f"{s.site}:at={s.at_step},kind={s.kind}"
                            for s in jcs._draw_plan(random.Random(1))]


def test_cli_raises_without_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.main(["--seed", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.main(["--elastic", "--seed", "0", "--platform", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.run(0, world=WORLD)
