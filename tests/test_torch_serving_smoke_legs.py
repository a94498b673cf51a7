"""The port's serving smoke tool, its router, fleet, autoscale,
disaggregated and online legs: one fixed-seed run each at the tools'
own size on the CPU (the fleet and router legs with two replicas, the
fewest their assertions allow), each result holding every key the
reference's leg writes.  Draws, tokens and the cheaper legs are in
``test_torch_serving_smoke.py``."""

from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch.tools import serving_smoke as ss
from test_torch_serving_smoke import reference_keys
from torch_port_obs import port_obs  # noqa: F401  (autouse)

REF = Path(__file__).resolve().parents[1] / "tools" / "serving_smoke.py"
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models: torch's intra-op threads only spin (and slow the
    other test workers); one thread for this module, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_replicas_leg_with_trace(tmp_path):
    """The router leg and every assertion of it but its throughput floor,
    a wall-clock claim that a shared CPU cannot hold steady (0.54x
    against 1.0-1.7x alone, in a six-worker run of the suite);
    ``chip_smoke.py`` phase 15k runs ``--replicas 2`` with it on the
    card."""
    out = ss._replicas(48, 8, 0, 2, 6, False, str(tmp_path / "t.json"),
                       None, CPU)
    assert out["aggregate_hit_rate"] >= out["single_hit_rate"] - 0.05
    assert out["parity_checked"] > 0 and out["trace"]["routed_breakdown_rows"]
    assert reference_keys(REF, "run_replicas",
                          optional={"lockguard_violations"}) <= set(out)


def test_fleet_leg_two_process_replicas():
    out = ss.run_fleet(replicas=2, requests=16, threads=4, device=CPU)
    assert out["federated_tokens"] == out["client_tokens"]
    assert out["stale_replicas"] == [out["killed_replica"]] == ["p1"]
    assert reference_keys(REF, "run_fleet") <= set(out)


def test_autoscale_leg():
    out = ss.run_autoscale(device=CPU)
    assert out["pool_sizes"] == [1, 2, 1] and out["probe_parity"]
    assert out["autoscale"]["saved_frac"] >= 0.2
    assert reference_keys(REF, "run_autoscale") <= set(out)


def test_disagg_leg_workload():
    """The disaggregated leg's workload and every assertion of the leg
    but its p99 inter-token isolation, a wall-clock claim that a shared
    CPU cannot hold steady (0.85-1.36x between runs of this test on one
    machine); ``chip_smoke.py`` phase 15k holds it on the card."""
    out, ratio = ss._disagg(24, 3, 0, False, None, None, CPU)
    assert out["disagg"]["pages_deduped"] > 0 and out["migrations"] > 0
    assert ratio is not None and ratio > 0
    assert reference_keys(REF, "run_disagg") <= set(out)


@pytest.mark.parametrize("rounds", [2])
def test_online_leg(rounds):
    out = ss.run_online(rounds=rounds, device=CPU)
    assert out["ok"], out["failures"]
    assert "ok" in out["rounds"] and out["online.reloads"] >= 1
    assert reference_keys(REF, "run_online") <= set(out)
