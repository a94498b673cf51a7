"""ZeRO checkpoints of the port across dp widths, stages and packages,
over gloo CPU ranks.

The port's multi-rank checkpoint: the mesh's ranks gather what they hold,
the first rank writes the reference's on-disk format, the others wait at
a barrier, and every rank restores its own chunk.  A checkpoint written
at one width restores at another (``reshard=True``, the trainer's
default) and the run continues; the continuation is held to the
reference's straight-through run at dp=1 stage 0 (``_reference_losses``,
the reference test's fixture).  Checkpoints cross between the packages in
both directions: the port's restore in the reference's trainer, and the
reference's in the port's.

Tolerance: 1e-5 absolute on the losses (float32) — the reference's
documented cross-width window; its own bitwise cases across widths fail
in the reference itself (``ROADMAP.md`` §C), so none is held bitwise
here.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.optimize import transforms as JT
from deeplearning4j_tpu.parallel import DataParallelTrainer as JTrainer
from deeplearning4j_tpu.parallel.checkpoint import CheckpointManager as JMgr
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JSpec
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake
from torch_ranks import RankPool, np_data, np_params

TOL = 1e-5
WORLD = 4
SPLIT, STEPS = 3, 6


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _jloss(params, x, y, key=None):
    return ((x @ params["w"] + params["b"] - y) ** 2).mean()


def _jtrainer(n, stage):
    return JTrainer(_jloss, JT.adam(1e-2),
                    mesh=jmake(JSpec(dp=n), devices=jax.devices()[:n]),
                    zero_stage=stage)


_REF = {}


def _reference_losses():
    """Unsharded fixed-seed reference: dp=1, stage 0, straight through."""
    if "losses" not in _REF:
        tr = _jtrainer(1, 0)
        s = tr.init_state(np_params())
        out = []
        for x, y in np_data(STEPS):
            s, lz = tr.step(s, x, y)
            out.append(float(lz))
        _REF["losses"] = np.array(out[SPLIT:])
    return _REF["losses"]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=TOL)


def _port_roundtrip(pool, root, save_dp, load_dp, save_stage=2,
                    load_stage=2, layout="natural"):
    assert pool.run("ckpt_save", str(root), save_dp, save_stage, SPLIT,
                    layout)[0] == SPLIT
    res = pool.run("ckpt_continue", str(root), load_dp, load_stage, SPLIT,
                   STEPS)
    assert res[0]["start"] == SPLIT
    for r in range(1, load_dp):
        assert res[r] == res[0]
    return res[0]["losses"]


@pytest.mark.parametrize("save_dp,load_dp", [(2, 1), (1, 2), (4, 2), (2, 4)])
def test_zero2_checkpoint_resharding_across_dp_widths(pool, tmp_path,
                                                      save_dp, load_dp):
    """A ZeRO-2 checkpoint written by the port at one width restores in the
    port at another and continues within 1e-5 of the reference's
    straight-through run; the manifest records the save-side width."""
    got = _port_roundtrip(pool, tmp_path, save_dp, load_dp)
    _close(got, _reference_losses())
    r = JMgr(tmp_path).restore(np_params())
    assert r["extra"] == {"zero_stage": 2, "saved_dp": save_dp}


@pytest.mark.parametrize("save_stage,load_stage",
                         [(0, 2), (2, 0), (3, 0), (1, 3), (3, 1)])
def test_zero_checkpoints_interoperate_across_stages(pool, tmp_path,
                                                     save_stage, load_stage):
    """One natural on-disk layout: a checkpoint of any stage restores under
    any other (dp=2 both sides)."""
    got = _port_roundtrip(pool, tmp_path, 2, 2, save_stage, load_stage)
    _close(got, _reference_losses())


@pytest.mark.parametrize("save_dp,load_dp", [(4, 2), (2, 1)])
def test_flat_layout_checkpoint_restores_across_widths(pool, tmp_path,
                                                       save_dp, load_dp):
    """``layout="flat"``: the padded P('dp') leaves written at one width are
    re-split on the host at another, in the port and in the reference."""
    got = _port_roundtrip(pool, tmp_path, save_dp, load_dp, 3, 3,
                          layout="flat")
    _close(got, _reference_losses())
    meta = JMgr(tmp_path).restore(np_params())
    assert meta["saved_dp"] == save_dp and meta["zero_stage"] == 3


@pytest.mark.parametrize("save_dp,load_dp,stage", [(2, 1, 2), (4, 2, 1),
                                                   (2, 4, 3)])
def test_port_checkpoint_restores_in_the_reference(pool, tmp_path, save_dp,
                                                   load_dp, stage):
    """The port writes at ``save_dp``; the reference's trainer restores at
    ``load_dp`` and continues within 1e-5 of its straight-through run."""
    pool.run("ckpt_save", str(tmp_path), save_dp, stage, SPLIT)
    tr = _jtrainer(load_dp, stage)
    s = tr.restore(tr.init_state(np_params()), JMgr(tmp_path, keep=2))
    assert s.step == SPLIT
    losses = []
    for x, y in np_data(STEPS)[SPLIT:]:
        s, lz = tr.step(s, x, y)
        losses.append(float(lz))
    _close(losses, _reference_losses())


@pytest.mark.parametrize("save_dp,load_dp,stage", [(1, 2, 2), (2, 4, 2),
                                                   (4, 2, 3), (2, 1, 0)])
def test_reference_checkpoint_restores_in_the_port(pool, tmp_path, save_dp,
                                                   load_dp, stage):
    """The reference writes at ``save_dp``; the port's ranks restore at
    ``load_dp`` and continue within 1e-5."""
    tr = _jtrainer(save_dp, stage)
    s = tr.init_state(np_params())
    for x, y in np_data(SPLIT):
        s, _ = tr.step(s, x, y)
    tr.checkpoint(s, JMgr(tmp_path, keep=2))
    res = pool.run("ckpt_continue", str(tmp_path), load_dp, stage, SPLIT,
                   STEPS)
    assert res[0]["start"] == SPLIT
    _close(res[0]["losses"], _reference_losses())


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_cross_width_restore_without_reshard_raises(pool, tmp_path, stage):
    """``reshard=False`` across widths raises ``MeshMismatchError`` on every
    member — never a shape error, never a silent load."""
    pool.run("ckpt_save", str(tmp_path), 2, stage, SPLIT)
    res = pool.run("ckpt_continue", str(tmp_path), 4, stage, SPLIT, STEPS,
                   reshard=False)
    assert res == ["MeshMismatchError"] * WORLD


def test_hogwild_checkpoint_stacks_replicas(pool, tmp_path):
    """Hogwild writes one replica a rank, stacked on a leading dp axis (the
    reference's layout); restoring at the same width continues as the
    uninterrupted run.  (Uniform batches: a replica's rows follow the
    bucket ladder, which a fresh trainer anchors on the first batch it
    sees.)"""
    straight = pool.run("train", 2, 0, "momentum", STEPS, router="hogwild",
                        average_every=2, uniform=True)[0]
    pool.run("ckpt_save", str(tmp_path), 2, 0, 4, tx="momentum",
             router="hogwild", uniform=True)
    r = JMgr(tmp_path).restore(
        {"w": np.zeros((2, 6, 1), np.float32),
         "b": np.zeros((2, 1), np.float32)})
    assert r["params"]["w"].shape == (2, 6, 1)
    res = pool.run("ckpt_continue", str(tmp_path), 2, 0, 4, STEPS,
                   tx="momentum", router="hogwild", uniform=True)
    assert res[0]["start"] == 4
    _close(res[0]["losses"], straight["losses"][4:])
