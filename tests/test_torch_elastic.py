"""Elastic resize of the port's supervised trainer over gloo CPU ranks.

The reference's elastic contract (``tests/test_elastic_reshard.py``),
with ranks for devices: ``mesh.shrink`` fires on every rank at one step
(``kind`` = ranks lost, the mesh's last), each rank raises
``DeviceLossError``, and the supervisor rebuilds its trainer through the
factory over the survivors and reshard-restores from the newest
checkpoint; the lost ranks stay alive outside the mesh (spectators that
keep the step count), and ``mesh.grow`` drains the run and rebuilds over
all of them again.  Every step's loss must fall inside the reference's
documented window (|Δ| <= 1e-5, float32) of the un-faulted run, and the
un-faulted run at dp=4 inside that window of the reference's.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.optimize import transforms as JT
from deeplearning4j_tpu.parallel import DataParallelTrainer as JTrainer
from deeplearning4j_tpu.parallel import elastic_mesh as jelastic
from torch_ranks import RankPool, elastic_data, elastic_params

WINDOW = 1e-5
WORLD = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


class _Batch:
    def __init__(self, x, y):
        self.features, self.labels = x, y


def _window(res):
    ref = res["ref_losses"]
    return max(abs(v - ref[s - 1]) for s, v in res["losses_by_step"].items())


def test_unfaulted_fit_matches_the_reference(pool, tmp_path):
    """The supervised fit with no fault at dp=4 (ZeRO-1) against the
    reference's trainer on four devices."""
    res = pool.run("elastic", str(tmp_path))
    jtr = JTrainer(lambda p, x, y, key=None: ((x @ p["w"] - y) ** 2).mean(),
                   JT.adam(1e-3), mesh=jelastic(jax.devices()[:4]),
                   zero_stage=1)
    data = [_Batch(x, y) for x, y in elastic_data()]
    _, jl = jtr.fit(jtr.init_state(elastic_params()), data, epochs=1)
    np.testing.assert_allclose(res[0]["ref_losses"], jl, rtol=0, atol=WINDOW)
    assert res[0]["step"] == len(data) and res[0]["mesh_sizes"] == []
    assert _window(res[0]) == 0.0


def test_supervisor_survives_device_loss(pool, tmp_path):
    """``mesh.shrink`` loses 2 ranks at step 4: the survivors rebuild at
    dp=2, reshard-restore and finish every step inside the window; the
    lost ranks end outside the mesh; a ``mesh_resize`` bundle and the
    elastic gauges are on record."""
    res = pool.run("elastic", str(tmp_path), [("mesh.shrink", 4, "2")])
    r0 = res[0]
    assert r0["step"] == 8
    assert r0["resizes"] == 1 and r0["mesh_sizes"] == [2]
    assert r0["mesh_size"] == 2 and r0["bundles"] >= 1
    assert _window(r0) <= WINDOW, _window(r0)
    assert r0["counters"]["resilience.device_losses"] == 1
    assert r0["counters"]["elastic.mesh_resizes"] == 1
    assert r0["counters"]["checkpoint.reshards"] >= 1
    assert r0["gauges"]["elastic.mesh_size"] == 2
    assert r0["gauges"]["elastic.resizes_total"] == 1
    assert [r["member"] for r in res] == [True, True, False, False]
    assert all(r["mesh_sizes"] == [2] for r in res)


def test_supervisor_shrinks_then_grows_back(pool, tmp_path):
    """Shrink by 2 at step 3, grow at step 5: dp 4 -> 2 -> 4, every rank a
    member again at the end, every step inside the window."""
    res = pool.run("elastic", str(tmp_path), [("mesh.shrink", 3, "2"),
                                              ("mesh.grow", 5, None)])
    for r in res:
        assert r["step"] == 8 and r["mesh_sizes"] == [2, 4]
        assert r["mesh_size"] == 4 and r["member"]
    assert _window(res[0]) <= WINDOW, _window(res[0])
    # the steps from the restored checkpoint (step 2) on, each once
    assert set(res[0]["losses_by_step"]) == set(range(3, 9))


def test_device_loss_without_factory_propagates(pool, tmp_path):
    """A plain trainer (no factory) cannot rebuild its mesh: the loss
    propagates on every rank instead of retrying onto dead hardware."""
    res = pool.run("elastic", str(tmp_path), [("mesh.shrink", 2, None)],
                   factory=False)
    assert [r["error"] for r in res] == ["DeviceLossError"] * WORLD
    assert all("lost 1 device(s) [3] at step 2" in r["message"] for r in res)
