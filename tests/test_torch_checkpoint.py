"""Checkpoints of the port against the JAX package's: one format for both.

A checkpoint written by one package's ``TransformerLM.fit(
checkpoint_manager=...)`` restores into the other with params and
optimizer state bitwise equal (``verify()`` true on both sides), and a
resumed fit continues the other's run.  A ZeRO checkpoint the reference
wrote at dp=2 in its flat padded layout restores into the port at dp=1
with ``reshard=True`` and raises ``MeshMismatchError`` without it.  The
integrity cases (checksums, walk-back, explicit-step corruption, the
``checkpoint.write`` fault site, scalar leaves, unused keys, quarantine,
rotation, read-only opens) follow ``tests/test_resilience.py``'s, on the
port's manager.  Inputs are seeded numpy arrays; everything is float32.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.optimize import transforms as JT
from deeplearning4j_tpu.parallel import checkpoint as jck
from deeplearning4j_tpu.parallel import trainer as jtrn
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.observability import METRICS
from deeplearning4j_tpu_torch.optimize import transforms as TT
from deeplearning4j_tpu_torch.parallel import (CheckpointCorruptError,
                                               CheckpointManager,
                                               DataParallelTrainer,
                                               MeshMismatchError)
from deeplearning4j_tpu_torch.parallel import zero as tzero
from deeplearning4j_tpu_torch.resilience import (FaultSpec, corrupt_file,
                                                 inject_faults)
from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves
from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"
# a resumed 2-layer run against the other package's: f32 reassociation
TOL_LOSS = 1e-5
SHAPE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=16)


def _models():
    jm = jtr.TransformerLM(jtr.TransformerConfig(**SHAPE,
                                                 dtype=jnp.float32))
    tm = ttr.TransformerLM(ttr.TransformerConfig(**SHAPE,
                                                 dtype=torch.float32),
                           device=CPU)
    return jm, tm


def _txs(kind):
    if kind == "adamw":
        return (JT.adamw(JT.warmup_cosine(1e-3, 2, 10), weight_decay=0.01),
                TT.adamw(TT.warmup_cosine(1e-3, 2, 10), weight_decay=0.01))
    return (JT.chain(JT.momentum(0.9), JT.sgd_lr(1e-2)),
            TT.chain(TT.momentum(0.9), TT.sgd_lr(1e-2)))


def _batches(n=4, b=2, t=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, SHAPE["vocab_size"], (b, t)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def _np_leaves(tree):
    """Leaves in the checkpoint's path order, as numpy."""
    from deeplearning4j_tpu_torch.parallel.checkpoint import _walk
    out = []
    for _, leaf in _walk(tree):
        if torch.is_tensor(leaf):
            out.append(leaf.detach().numpy())
        else:
            out.append(np.asarray(leaf))
    return out


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.astype(w.dtype) if g.ndim == 0
                                      else g, w)


@pytest.mark.parametrize("opt", ["adamw", "momentum"])
def test_reference_fit_checkpoint_restores_into_the_port(tmp_path, opt):
    jm, tm = _models()
    jtx, ttx = _txs(opt)
    batches = _batches()
    # the reference's step donates its inputs: a fresh tree every fit
    def jfresh():
        jp = jm.init(jax.random.key(0))
        return jp, jm.init_opt(jp, jtx)

    jmgr = jck.CheckpointManager(tmp_path / "ref", keep=5)
    jp2, jopt2, jl = jm.fit(*jfresh(), batches, tx=jtx,
                            checkpoint_manager=jmgr, checkpoint_every=2)
    assert jmgr.all_steps() == [2, 4]

    mgr = CheckpointManager(tmp_path / "ref", keep=5)
    assert all(mgr.verify(s) for s in mgr.all_steps())
    tp = tm.init()
    topt = tm.init_opt(tp, ttx)
    r = mgr.restore(tp, tstate_template=topt)
    assert r["step"] == 4 and r["data_cursor"] == 4
    assert type(r["tstate"][0]) is int and r["tstate"][0] == 4
    _assert_bitwise(_np_leaves(r["params"]), _jax_leaves(jp2))
    _assert_bitwise(_np_leaves(r["tstate"]), _jax_leaves(jopt2))
    assert all(torch.is_tensor(x) and x.dtype == torch.float32
               for x in tree_leaves(r["params"]))

    # the port's fit resumes the reference's run from its checkpoint ...
    tm_mgr = CheckpointManager(tmp_path / "ref", keep=5)
    _, topt3, tl = tm.fit(tp, topt, batches, tx=ttx, epochs=2,
                          checkpoint_manager=tm_mgr, checkpoint_every=2)
    # ... as the reference's own resumed fit continues it
    jmgr2 = jck.CheckpointManager(tmp_path / "ref2", keep=5)
    jm.fit(*jfresh(), batches, tx=jtx, checkpoint_manager=jmgr2,
           checkpoint_every=2)
    _, jopt3, jl3 = jm.fit(*jfresh(), batches, tx=jtx, epochs=2,
                           checkpoint_manager=jmgr2, checkpoint_every=2)
    assert topt3[0] == int(jopt3[0]) == 8 and len(tl) == len(jl3) == 4
    np.testing.assert_allclose(tl, jl3, rtol=TOL_LOSS)
    assert tm_mgr.all_steps()[-1] == 8


@pytest.mark.parametrize("opt", ["adamw", "momentum"])
def test_port_fit_checkpoint_restores_into_the_reference(tmp_path, opt):
    jm, tm = _models()
    jtx, ttx = _txs(opt)
    batches = _batches(seed=1)
    tp = tm.init()
    mgr = CheckpointManager(tmp_path / "port", keep=5)
    tp2, topt2, _ = tm.fit(tp, tm.init_opt(tp, ttx), batches, tx=ttx,
                           checkpoint_manager=mgr, checkpoint_every=2)
    assert mgr.all_steps() == [2, 4] and all(mgr.verify(s) for s in (2, 4))
    meta = json.loads((tmp_path / "port" / "ckpt_0000000004" /
                       "meta.json").read_text())
    assert set(meta["checksums"]) == {"params.npz", "tstate.npz"}
    assert meta["step"] == meta["data_cursor"] == 4

    jmgr = jck.CheckpointManager(tmp_path / "port", keep=5)
    assert all(jmgr.verify(s) for s in (2, 4))
    jp = jm.init(jax.random.key(3))
    r = jmgr.restore(jp, tstate_template=jm.init_opt(jp, jtx))
    assert r["step"] == 4 and int(r["tstate"][0]) == 4
    _assert_bitwise(_jax_leaves(r["params"]), _np_leaves(tp2))
    _assert_bitwise(_jax_leaves(r["tstate"]), _np_leaves(topt2))


def test_trainer_checkpoints_interoperate_with_key_and_cursor(tmp_path):
    """The trainers' checkpoints carry the key as uint32[2] words both
    ways (the values seed different streams in the two packages)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    y = rng.normal(size=(8, 1)).astype(np.float32)
    params = {"w": np.zeros((3, 1), np.float32)}
    mesh = make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    jt = jtrn.DataParallelTrainer(
        lambda p, a, b, k=None: jnp.mean((a @ p["w"] - b) ** 2),
        JT.chain(JT.momentum(0.9), JT.sgd_lr(0.1)), mesh=mesh)
    js = jt.init_state(params, key=jax.random.key(7))
    js, _ = jt.step(js, x, y)
    jt.checkpoint(js, jck.CheckpointManager(tmp_path / "a"))

    tt = DataParallelTrainer(
        lambda p, a, b, g=None: ((a @ p["w"] - b) ** 2).mean(),
        TT.chain(TT.momentum(0.9), TT.sgd_lr(0.1)), device=CPU)
    ts = tt.restore(tt.init_state(params), CheckpointManager(tmp_path / "a"))
    assert ts.step == 1 and ts.key.dtype == np.uint32
    np.testing.assert_array_equal(ts.key,
                                  np.asarray(jax.random.key_data(js.key)))
    np.testing.assert_array_equal(ts.params["w"].numpy(),
                                  np.asarray(js.params["w"]))

    ts, _ = tt.step(ts, x, y)
    tt.checkpoint(ts, CheckpointManager(tmp_path / "b"))
    js2 = jt.restore(jt.init_state(params), jck.CheckpointManager(
        tmp_path / "b"))
    assert js2.step == 2
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(js2.key)),
                                  ts.key)
    np.testing.assert_array_equal(np.asarray(js2.params["w"]),
                                  ts.params["w"].numpy())


def test_bf16_leaves_saved_by_the_reference_read_as_bf16(tmp_path):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    jmgr = jck.CheckpointManager(tmp_path, keep=3)
    jmgr.save(1, {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.ones(3)})
    raw = np.load(tmp_path / "ckpt_0000000001" / "params.npz")["['w']"]
    assert raw.dtype.itemsize == 2 and raw.dtype.kind not in "iuf"
    out = CheckpointManager(tmp_path).restore(
        {"w": torch.zeros((5, 3), dtype=torch.bfloat16),
         "b": torch.zeros(3)})["params"]
    assert out["w"].dtype == torch.bfloat16
    want = torch.from_numpy(w).to(torch.bfloat16)
    assert torch.equal(out["w"], want)
    # and the port writes bf16 in the same bytes
    CheckpointManager(tmp_path / "port").save(1, {"w": want})
    again = np.load(tmp_path / "port" / "ckpt_0000000001" /
                    "params.npz")["['w']"]
    assert again.dtype == raw.dtype and again.tobytes() == raw.tobytes()


@pytest.mark.parametrize("stage", [1, 3])
def test_reference_zero_checkpoint_at_dp2_restores_at_dp1(tmp_path, stage):
    """A ZeRO run of the reference at dp=2 saves its flat padded P('dp')
    leaves as they are (``layout="flat"``); the port's trainer (dp=1)
    re-splits them on the host with ``reshard=True`` — the values equal
    the reference's own natural view — and refuses without it."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    y = rng.normal(size=(8, 3)).astype(np.float32)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "b": np.zeros((3,), np.float32)}   # 15 and 3 elements: padded

    def jloss(p, a, b, k=None):
        return jnp.mean((a @ p["w"] + p["b"] - b) ** 2)

    mesh = make_mesh(MeshSpec(dp=2), devices=jax.devices()[:2])
    jt = jtrn.DataParallelTrainer(jloss, JT.adamw(1e-2), mesh=mesh,
                                  zero_stage=stage)
    js = jt.init_state(params)
    for _ in range(2):
        js, _ = jt.step(js, x, y)
    jt.checkpoint(js, jck.CheckpointManager(tmp_path), layout="flat")
    meta = json.loads((tmp_path / "ckpt_0000000002" / "meta.json")
                      .read_text())
    assert meta["topology"] == {"dp": 2, "zero_stage": stage,
                                "layout": "flat"}
    raw = np.load(tmp_path / "ckpt_0000000002" / "tstate.npz")
    assert all(raw[k].ndim == 1 and raw[k].shape[0] % 2 == 0 for k in raw)

    z = jt._zero
    want_params = _jax_leaves(jt.final_params(js))
    want_tstate = _jax_leaves(z.to_natural_host(js.tstate, z.natural_tstate))

    tt = DataParallelTrainer(
        lambda p, a, b, g=None: ((a @ p["w"] + p["b"] - b) ** 2).mean(),
        TT.adamw(1e-2), device=CPU)
    template = tt.init_state(params)
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(MeshMismatchError, match="dp=2 cannot restore onto "
                                                "dp=1"):
        tt.restore(template, mgr, reshard=False)
    with pytest.raises(MeshMismatchError):
        mgr.restore(template.params, tstate_template=template.tstate,
                    dp_width=1)
    ts = tt.restore(template, mgr)
    assert ts.step == 2
    _assert_bitwise(_np_leaves(ts.params), want_params)
    _assert_bitwise(_np_leaves(ts.tstate), want_tstate)
    assert METRICS.snapshot()["counters"]["checkpoint.reshards"] == 1
    ts, lazy = tt.step(ts, x, y)           # and it trains on from there
    assert np.isfinite(float(lazy))


def test_host_flat_layout_round_trip():
    a = np.arange(15, dtype=np.float32).reshape(5, 3)
    for dp in (1, 2, 4, 16):
        flat = tzero.host_natural_to_flat(a, dp)
        assert flat.shape == (tzero.flat_padded_size(15, dp),)
        assert not flat[15:].any()
        np.testing.assert_array_equal(
            tzero.host_flat_to_natural(flat, (5, 3), dp), a)
    with pytest.raises(ValueError):
        tzero.host_flat_to_natural(np.zeros(17), (5, 3), 2)


# ------------------------------------------------------------ integrity

def _save_steps(mgr, steps):
    for s in steps:
        mgr.save(s, {"w": torch.full((4,), float(s))})


def test_checksum_verify_detects_corruption(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=10)
    _save_steps(mgr, [1, 2, 3])
    assert all(mgr.verify(s) for s in (1, 2, 3))
    for kind in ("truncate", "bitflip"):
        corrupt_file(tmp_path / "ckpt_0000000003" / "params.npz", kind)
        assert not mgr.verify(3)
    assert mgr.latest_valid_step() == 2
    # the reference's manager reads the same manifest the same way
    assert jck.CheckpointManager(tmp_path).latest_valid_step() == 2


def test_restore_falls_back_to_newest_valid(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=10)
    _save_steps(mgr, [1, 2, 3])
    corrupt_file(tmp_path / "ckpt_0000000003" / "params.npz", "bitflip")
    with pytest.warns(UserWarning, match="failed checksum"):
        out = mgr.restore({"w": torch.zeros(4)})
    assert out["step"] == 2
    assert torch.equal(out["params"]["w"], torch.full((4,), 2.0))
    assert METRICS.snapshot()["counters"]["checkpoint.corrupt_detected"] == 1


def test_explicit_corrupt_step_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=10)
    _save_steps(mgr, [1])
    corrupt_file(tmp_path / "ckpt_0000000001" / "params.npz", "truncate")
    with pytest.raises(CheckpointCorruptError):
        mgr.restore({"w": torch.zeros(4)}, step=1)
    with pytest.raises(FileNotFoundError, match="all corrupt"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mgr.restore({"w": torch.zeros(4)})
    # the explicit-step failure left a flight-recorder bundle
    from deeplearning4j_tpu_torch.observability import FLIGHTREC
    assert list(FLIGHTREC.dump_dir.glob("flightrec-checkpoint_corrupt-*"))


def test_checkpoint_write_fault_site_corrupts_published_payload(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=10)
    with inject_faults(FaultSpec("checkpoint.write", at_step=2,
                                 kind="bitflip")):
        _save_steps(mgr, [1, 2])
    assert mgr.verify(1) and not mgr.verify(2)
    assert mgr.latest_valid_step() == 1
    counters = METRICS.snapshot()["counters"]
    assert counters["faults.injected.checkpoint.write"] == 1


def test_restore_like_scalar_and_bool_leaves(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, {"w": torch.ones(4), "count": 3, "rate": 0.5, "flag": True,
                 "host": np.arange(3), "none": None})
    out = mgr.restore({"w": torch.zeros(4), "count": 0, "rate": 0.0,
                       "flag": False, "host": np.zeros(3, np.int64),
                       "none": None})["params"]
    assert out["count"] == 3 and type(out["count"]) is int
    assert out["rate"] == 0.5 and out["flag"] is True
    assert out["none"] is None
    np.testing.assert_array_equal(out["host"], np.arange(3))
    # a count the reference saved as a 0-d int32 array restores to an int
    jck.CheckpointManager(tmp_path / "j").save(
        1, {"w": jnp.ones(4)}, tstate=(jnp.zeros((), jnp.int32) + 5, ()))
    r = CheckpointManager(tmp_path / "j").restore(
        {"w": torch.zeros(4)}, tstate_template=(0, ()))
    assert r["tstate"] == (5, ()) and type(r["tstate"][0]) is int


def test_restore_warns_on_unused_checkpoint_keys(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, {"w": torch.ones(4), "extra": torch.zeros(2)})
    with pytest.warns(UserWarning, match="absent from the restore template"):
        out = mgr.restore({"w": torch.zeros(4)})
    assert "extra" not in out["params"]
    assert METRICS.snapshot()["counters"]["checkpoint.unused_keys"] == 1
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"w": torch.zeros(4), "other": torch.zeros(1)})


def test_shape_guard_names_the_leaf(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, {"w": torch.ones(4)})
    with pytest.raises(MeshMismatchError, match=r"leaf \['w'\] has shape"):
        mgr.restore({"w": torch.zeros(5)})


def test_rotation_keeps_the_newest_and_republish_replaces(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    _save_steps(mgr, [1, 2, 3, 4])
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    mgr.save(4, {"w": torch.full((4,), 9.0)})      # same-step republish
    assert mgr.all_steps() == [3, 4]
    out = mgr.restore({"w": torch.zeros(4)})
    assert torch.equal(out["params"]["w"], torch.full((4,), 9.0))
    # no temp or trash dirs left behind; a ckpt_* dir without meta.json
    # (a crashed writer's residue) is never listed
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_0000000003", "ckpt_0000000004"]
    (tmp_path / "ckpt_0000000009").mkdir()
    assert mgr.all_steps() == [3, 4]


def test_quarantine_retires_a_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    _save_steps(mgr, [1, 2])
    dst = mgr.quarantine(2)
    assert dst.name == "bad_0000000002" and dst.is_dir()
    assert mgr.all_steps() == [1] and mgr.latest_valid_step() == 1
    assert METRICS.snapshot()["counters"]["checkpoint.quarantined"] == 1
    with pytest.raises(FileNotFoundError):
        mgr.quarantine(7)


def test_read_only_open(tmp_path):
    with pytest.raises(FileNotFoundError, match="does not exist"):
        CheckpointManager.open_read_only(tmp_path / "missing")
    assert not (tmp_path / "missing").exists()
    _save_steps(CheckpointManager(tmp_path), [1])
    ro = CheckpointManager.open_read_only(tmp_path)
    assert ro.latest_valid_step() == 1
    assert ro.restore({"w": torch.zeros(4)})["step"] == 1
    with pytest.raises(RuntimeError, match="read-only"):
        ro.save(2, {"w": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="read-only"):
        ro.quarantine(1)


def test_meta_matches_the_reference_fields(tmp_path):
    """Both packages stamp the same meta.json fields for the same save."""
    CheckpointManager(tmp_path / "t").save(
        3, {"w": torch.ones(2)}, tstate=(3, ()),
        key=np.array([0, 7], np.uint32), data_cursor=3,
        dp_width=1, zero_stage=0)
    jck.CheckpointManager(tmp_path / "j").save(
        3, {"w": jnp.ones(2)}, tstate=(3, ()), key=jax.random.key(7),
        data_cursor=3, dp_width=1, zero_stage=0)
    t = json.loads((tmp_path / "t" / "ckpt_0000000003" / "meta.json")
                   .read_text())
    j = json.loads((tmp_path / "j" / "ckpt_0000000003" / "meta.json")
                   .read_text())
    assert set(t) == set(j)
    assert {k: t[k] for k in t if k != "checksums"} == \
        {k: j[k] for k in j if k != "checksums"}
    assert set(t["checksums"]) == set(j["checksums"])
    tk = np.load(tmp_path / "t" / "ckpt_0000000003" / "key.npy")
    jk = np.load(tmp_path / "j" / "ckpt_0000000003" / "key.npy")
    assert tk.dtype == jk.dtype and np.array_equal(tk, jk)


def test_restore_template_of_shapes_only(tmp_path):
    """A ``meta`` tensor (a shape, no storage) as template restores on the
    CPU."""
    _, tm = _models()
    tp = tm.init()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tp)
    tmpl = dict(tp, tok_embed=torch.empty(tp["tok_embed"].shape,
                                          device="meta"))
    out = mgr.restore(tmpl)["params"]
    assert out["tok_embed"].device.type == "cpu"
    assert torch.equal(out["tok_embed"], tp["tok_embed"])
