"""The port's data-parallel trainer (one device) against the JAX package's.

The same seeded numpy batches go through the reference's
``DataParallelTrainer`` on a one-device mesh and the port's: over a ragged
stream the per-step losses agree within ``TOL_LOSS`` (f32, summation order
only) and the bucket counters are the same.  The rest follows
``tests/test_async_trainer.py``: the exact masked mean (pad-row contents
never change a step), lazy losses, the ring's self-fence, the checkpoint
fence, one-shot generators, ``prefetch_to_device`` and its thread's
lifecycle — and the hot loop under ``NoHostSync``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.observability import METRICS as JMETRICS
from deeplearning4j_tpu.optimize import transforms as JT
from deeplearning4j_tpu.parallel import trainer as jtrn
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh
from deeplearning4j_tpu_torch.datasets import DataSet, prefetch_to_device
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.observability import METRICS
from deeplearning4j_tpu_torch.optimize import transforms as TT
from deeplearning4j_tpu_torch.parallel import (CheckpointManager,
                                               DataParallelTrainer, LazyLoss)
from deeplearning4j_tpu_torch.parallel.trainer import make_key, split_key
from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves
from torch_port_obs import port_obs  # noqa: F401  (autouse)
from torch_sync_guard import NoHostSync

CPU = "cpu"
TOL_LOSS = 1e-5        # f32: summation order only (tests/test_torch_train.py)
RAGGED = [32, 17, 9, 23, 32, 5, 29, 13]
BUCKET_COUNTERS = ("train_step.pad_batch", "train_step.padded_samples",
                   "train_step.recompile", "train_step.iterations",
                   "train_step.losses_resolved")


def _toy(seed=0, d=6):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d, 1))
    params = {"w": np.zeros((d, 1), np.float32)}
    return params, w, rng


def tloss(p, x, y, gen=None):
    return ((x @ p["w"] - y) ** 2).mean()


def jloss(p, x, y, key=None):
    return jnp.mean((x @ p["w"] - y) ** 2)


def _ragged(rng, w, sizes, d=6):
    out = []
    for n in sizes:
        x = rng.normal(size=(n, d)).astype(np.float32)
        out.append((x, (x @ w).astype(np.float32)))
    return out


def _xy(rng, w, n, d=6):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def _trainer(lr=0.05, **kw):
    return DataParallelTrainer(tloss, TT.sgd_lr(lr), device=CPU, **kw)


def _ref_mesh():
    return make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])


def _counters(snapshot):
    return {k: snapshot["counters"].get(k, 0.0) for k in BUCKET_COUNTERS}


# --------------------------------------------------------------- parity
@pytest.mark.parametrize("async_dispatch", [True, False])
def test_ragged_stream_matches_the_reference(async_dispatch):
    params, w, rng = _toy()
    data = _ragged(rng, w, RAGGED)
    jt = jtrn.DataParallelTrainer(
        jloss, JT.chain(JT.momentum(0.9), JT.sgd_lr(0.01)), mesh=_ref_mesh())
    js, jl = jt.fit(jt.init_state(params), [JDataSet(*b) for b in data],
                    epochs=2, async_dispatch=async_dispatch, resolve_every=3)
    tt = DataParallelTrainer(tloss, TT.chain(TT.momentum(0.9),
                                             TT.sgd_lr(0.01)), device=CPU)
    ts, tl = tt.fit(tt.init_state(params), [DataSet(*b) for b in data],
                    epochs=2, async_dispatch=async_dispatch, resolve_every=3)
    assert len(tl) == len(jl) == 2 * len(RAGGED)
    np.testing.assert_allclose(tl, jl, rtol=TOL_LOSS, atol=1e-7)
    np.testing.assert_allclose(ts.params["w"].numpy(),
                               np.asarray(js.params["w"]), atol=1e-6)
    assert _counters(METRICS.snapshot()) == _counters(JMETRICS.snapshot())
    assert METRICS.snapshot()["counters"]["train_step.recompile"] == 3
    assert sorted(tt._step_cache) == sorted(jt._step_cache) == [8, 16, 32]


def test_lm_trainer_matches_the_reference():
    """The flagship LM's loss through both trainers, ragged batches of
    token rows, adamw with warmup-cosine: losses and final params."""
    shape = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                 max_len=16)
    jcfg = jtr.TransformerConfig(**shape, dtype=jnp.float32)
    tcfg = ttr.TransformerConfig(**shape, dtype=torch.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jtr.TransformerLM(jcfg).init(jax.random.key(0)))
    rng = np.random.default_rng(3)
    data = []
    for n in (4, 3, 4, 1, 2):
        toks = rng.integers(0, 64, (n, 16)).astype(np.int32)
        data.append((toks, np.roll(toks, -1, axis=1)))
    jt = jtrn.DataParallelTrainer(
        lambda p, x, y, k=None: jtr.lm_loss_local(p, x, y, jcfg),
        JT.adamw(JT.warmup_cosine(1e-3, 2, 10), weight_decay=0.01),
        mesh=_ref_mesh())
    js, jl = jt.fit(jt.init_state(params), data, epochs=1)
    tt = DataParallelTrainer(
        lambda p, x, y, g=None: ttr.lm_loss_local(p, x, y, tcfg),
        TT.adamw(TT.warmup_cosine(1e-3, 2, 10), weight_decay=0.01),
        device=CPU)
    ts, tl = tt.fit(tt.init_state(params_from_numpy(params, CPU)), data)
    np.testing.assert_allclose(tl, jl, rtol=TOL_LOSS)
    from deeplearning4j_tpu_torch.parallel.checkpoint import _walk
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(js.params)]
    got = [leaf.numpy() for _, leaf in _walk(ts.params)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert _counters(METRICS.snapshot()) == _counters(JMETRICS.snapshot())


def test_padded_step_loss_is_the_reference_masked_mean():
    """A padded bucket's loss equals the reference's masked mean and
    ``loss_fn`` over the real rows alone, whatever the pad rows hold."""
    params, w, rng = _toy()
    x, y = _xy(rng, w, 13)
    direct = float(tloss({"w": torch.zeros((6, 1))}, torch.from_numpy(x),
                         torch.from_numpy(y)))
    # lr 0 keeps the params; a first batch of 16 sets the nominal size,
    # so the 13 rows pad to a bucket of 16 in both trainers
    jt = jtrn.DataParallelTrainer(jloss, JT.sgd_lr(0.0), mesh=_ref_mesh())
    js, _ = jt.step(jt.init_state(params), *_xy(rng, w, 16))
    _, jlazy = jt.step(js, x, y)                      # masked mean
    trainer = _trainer(lr=0.0)
    state, _ = trainer.step(trainer.init_state(params), *_xy(rng, w, 16))
    _, lazy = trainer.step(state, x, y)
    assert METRICS.snapshot()["counters"]["train_step.padded_samples"] == 3
    assert float(lazy) == pytest.approx(direct, rel=1e-6)
    assert float(lazy) == pytest.approx(float(jlazy), rel=TOL_LOSS)
    # garbage (even non-finite) pad rows change nothing
    xb, yb, n_valid, bucket = trainer._pad_to_bucket(x, y)
    assert (n_valid, bucket) == (13, 16)
    xb, yb = xb.copy(), yb.copy()
    xb[13:], yb[13:] = np.nan, 1e30
    st2, lazy2 = trainer._dispatch(state, xb, yb, n_valid, bucket)
    assert float(lazy2) == float(lazy)
    assert torch.isfinite(st2.params["w"]).all()


def test_pad_wraps_rows_in_order():
    trainer = _trainer()
    trainer._nominal = 16
    x = np.arange(5)[:, None].astype(np.float32)
    xb, yb, n, bucket = trainer._pad_to_bucket(x, x)
    assert (n, bucket) == (5, 8)
    np.testing.assert_array_equal(xb[:, 0], [0, 1, 2, 3, 4, 0, 1, 2])
    xt, _, _, _ = trainer._pad_to_bucket(torch.from_numpy(x[:3]),
                                         torch.from_numpy(x[:3]))
    assert xt[:, 0].tolist() == [0, 1, 2, 0]


def test_oversized_batch_gets_own_bucket():
    params, w, rng = _toy()
    trainer = _trainer()
    state = trainer.init_state(params)
    state, _ = trainer.step(state, *_xy(rng, w, 16))   # nominal 16
    state, _ = trainer.step(state, *_xy(rng, w, 40))   # > nominal: 40
    state, _ = trainer.step(state, *_xy(rng, w, 7))    # pow2 -> 8
    assert sorted(trainer._step_cache) == [8, 16, 40]
    assert METRICS.snapshot()["counters"]["train_step.recompile"] == 3


# --------------------------------------------------------------- lazy ring
def test_lazy_loss_handle():
    params, w, rng = _toy()
    trainer = _trainer()
    state = trainer.init_state(params)
    _, lazy = trainer.step(state, *_xy(rng, w, 16))
    assert isinstance(lazy, LazyLoss)
    assert not lazy.resolved and "pending" in repr(lazy)
    v = float(lazy)
    assert np.isfinite(v) and lazy.resolved
    assert f"{lazy:.3f}" == f"{v:.3f}"
    assert lazy.value() == v  # idempotent after resolution


def test_pending_ring_self_fences_at_max_pending():
    params, w, rng = _toy()
    trainer = _trainer(max_pending=4)
    state = trainer.init_state(params)
    for _ in range(10):
        state, _ = trainer.step(state, *_xy(rng, w, 16))
    # 10 = 4 + 4 + 2: two auto-resolves fired, two entries still pending
    assert len(trainer._pending) == 2
    assert METRICS.snapshot()["counters"]["train_step.losses_resolved"] == 8


def test_resolution_point_owns_the_gauges():
    params, w, rng = _toy()
    trainer = _trainer()
    state = trainer.init_state(params)
    losses = []
    for _ in range(3):
        state, lazy = trainer.step(state, *_xy(rng, w, 16))
        losses.append(lazy)
    assert "train_step.loss" not in METRICS.snapshot()["gauges"]
    vals = trainer._resolve_pending()
    snap = METRICS.snapshot()
    assert snap["gauges"]["train_step.loss"] == pytest.approx(vals[-1])
    assert snap["gauges"]["train_step.samples_per_sec"] > 0
    assert snap["timers"]["train_step.execute"]["count"] == 3
    assert [float(lz) for lz in losses] == vals


def test_checkpoint_fences_pending_ring(tmp_path):
    params, w, rng = _toy()
    trainer = _trainer()
    state = trainer.init_state(params)
    for _ in range(3):
        state, _ = trainer.step(state, *_xy(rng, w, 16))
    assert trainer._pending  # ring is hot
    mgr = CheckpointManager(tmp_path)
    trainer.checkpoint(state, mgr)
    assert not trainer._pending  # fenced before the save read params
    assert METRICS.snapshot()["counters"]["checkpoint.fences"] == 1
    assert mgr.latest_step() == state.step


@pytest.mark.parametrize("every,steps", [(2, [2, 4]), (3, [3, 4]),
                                         (0, [4])])
def test_fit_saves_every_n_and_the_end_once(tmp_path, every, steps):
    params, w, rng = _toy()
    data = _ragged(rng, w, [16, 16, 16, 16])
    mgr = CheckpointManager(tmp_path, keep=10)
    trainer = _trainer()
    state, _ = trainer.fit(trainer.init_state(params), data,
                           checkpoint_manager=mgr, checkpoint_every=every)
    assert mgr.all_steps() == steps and state.step == 4
    assert METRICS.snapshot()["counters"]["checkpoint.saves"] == len(steps)


def test_keys_split_on_the_host_deterministically():
    assert make_key(None).tolist() == [0, 0]
    assert make_key(7).tolist() == [0, 7]
    k = make_key(7)
    a, b = split_key(k)
    assert a.dtype == b.dtype == np.uint32 and a.shape == b.shape == (2,)
    assert [x.tolist() for x in split_key(k)] == [a.tolist(), b.tolist()]
    assert a.tolist() != b.tolist() != k.tolist()
    with pytest.raises(ValueError):
        make_key(np.zeros(3))


def test_resume_from_checkpoint_is_bitwise(tmp_path):
    """A fit stopped at a checkpoint and resumed ends bitwise equal to the
    uninterrupted fit (params, optimizer state, key)."""
    params, w, rng = _toy()
    data = _ragged(rng, w, RAGGED)
    make = lambda: DataParallelTrainer(  # noqa: E731
        tloss, TT.adamw(TT.warmup_cosine(1e-2, 2, 10)), device=CPU)
    t0 = make()
    ref, ref_l = t0.fit(t0.init_state(params, key=3), data)
    mgr = CheckpointManager(tmp_path, keep=10)
    t1 = make()
    t1.fit(t1.init_state(params, key=3), data[:5], checkpoint_manager=mgr)
    t2 = make()
    got, got_l = t2.fit(t2.init_state(params, key=3), data,
                        checkpoint_manager=mgr)
    assert got.step == ref.step == len(data) and len(got_l) == 3
    assert got_l == ref_l[5:]
    assert torch.equal(got.params["w"], ref.params["w"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got.tstate),
                                                  tree_leaves(ref.tstate)))
    assert got.key.tolist() == ref.key.tolist()


# --------------------------------------------------------------- streaming
def test_fit_streams_one_shot_generator():
    params, w, rng = _toy()

    def gen():
        for n in (16, 9, 16, 5):
            yield _xy(rng, w, n)

    trainer = _trainer()
    state, losses = trainer.fit(trainer.init_state(params), gen())
    assert state.step == 4 and len(losses) == 4
    assert all(isinstance(v, float) and np.isfinite(v) for v in losses)
    assert not trainer._pending  # fit's final resolve drained the ring


def test_fit_without_prefetch_matches_prefetched():
    params, w, rng = _toy()
    data = [DataSet(*b) for b in _ragged(rng, w, [16, 9, 12, 16])]
    t1 = _trainer()
    _, l1 = t1.fit(t1.init_state(params), data, prefetch_size=2)
    t2 = _trainer()
    _, l2 = t2.fit(t2.init_state(params), data, prefetch_size=0)
    assert l1 == l2


def test_hot_loop_has_no_host_sync():
    """Dispatching steps between fences reads nothing back: under
    ``NoHostSync`` a run of direct ``step`` calls and a whole ``fit``
    (which resolves once, at the end, by one stacked copy) pass."""
    params, w, rng = _toy()
    data = _ragged(rng, w, [16, 9, 16, 5, 16])
    trainer = _trainer(max_pending=64)
    state = trainer.init_state(params)
    batches = [tuple(torch.from_numpy(a) for a in b) for b in data]
    with NoHostSync() as guard:
        for x, y in batches:
            state, _ = trainer.step(state, x, y)
    assert guard.seen > 0 and len(trainer._pending) == len(batches)
    trainer._resolve_pending()
    t2 = _trainer()
    with NoHostSync():
        _, losses = t2.fit(t2.init_state(params), data, resolve_every=0)
    assert len(losses) == len(data)


def test_multi_device_options_raise():
    for kw in ({"mesh": object()}, {"router": "hogwild"},
               {"zero_stage": 1}):
        with pytest.raises(NotImplementedError, match="A10"):
            DataParallelTrainer(tloss, TT.sgd_lr(0.1), device=CPU, **kw)
    with pytest.raises(ValueError):
        DataParallelTrainer(tloss, TT.sgd_lr(0.1), router="x", device=CPU)
    with pytest.raises(ValueError):
        DataParallelTrainer(tloss, TT.sgd_lr(0.1), zero_stage=5, device=CPU)


# --------------------------------------------------------- prefetch_to_device
def test_prefetch_empty_iterable():
    assert list(prefetch_to_device([], device=CPU)) == []
    assert list(prefetch_to_device(iter([]), size=1, device=CPU)) == []


@pytest.mark.parametrize("host_thread", [False, True])
def test_prefetch_preserves_order_and_passes_non_arrays(host_thread):
    batches = [(np.full((4, 2), i), np.full((4, 1), -i), i)
               for i in range(5)]
    out = list(prefetch_to_device(iter(batches), size=1, device=CPU,
                                  host_thread=host_thread))
    assert len(out) == 5
    for i, (a, b, n) in enumerate(out):
        assert torch.is_tensor(a) and torch.is_tensor(b)
        np.testing.assert_array_equal(a.numpy(), batches[i][0])
        np.testing.assert_array_equal(b.numpy(), batches[i][1])
        assert n == i and isinstance(n, int)


def test_prefetch_sharding_waits_for_a_mesh():
    with pytest.raises(NotImplementedError, match="A10"):
        prefetch_to_device([], sharding=object(), device=CPU)


def test_prefetch_host_thread_exits_on_exhaustion():
    batches = ((np.full((4, 2), i), np.full((4, 1), i)) for i in range(6))
    pf = prefetch_to_device(batches, size=2, host_thread=True, device=CPU)
    assert len(list(pf)) == 6
    pf.thread.join(timeout=5.0)
    assert not pf.thread.is_alive()  # no leaked worker after exhaustion


def test_prefetch_host_thread_close_mid_stream():
    def gen():
        for i in range(1000):
            yield (np.full((4, 2), i),)

    pf = prefetch_to_device(gen(), size=2, host_thread=True, device=CPU)
    first = next(pf)
    np.testing.assert_array_equal(first[0].numpy(), np.full((4, 2), 0))
    pf.close()
    assert not pf.thread.is_alive()
    pf.close()  # idempotent


def test_prefetch_host_thread_propagates_source_error():
    def gen():
        yield (np.zeros((4, 2)),)
        raise RuntimeError("boom in the input pipeline")

    pf = prefetch_to_device(gen(), size=2, host_thread=True, device=CPU)
    with pytest.raises(RuntimeError, match="boom"):
        for _ in pf:
            pass
    pf.close()
    assert not pf.thread.is_alive()


# --------------------------------------------------------------- registry
def test_observe_many_batches_under_one_histogram():
    METRICS.observe_many("t.batch", [0.1, 0.2, 0.3])
    assert METRICS.snapshot()["timers"]["t.batch"]["count"] == 3
    METRICS.observe_many("t.batch", [])
    assert METRICS.snapshot()["timers"]["t.batch"]["count"] == 3


def test_fit_instruments_like_the_reference():
    """The same fit publishes the same counter names in both packages'
    registries (values of timings aside)."""
    params, w, rng = _toy()
    data = _ragged(rng, w, [16, 9, 16])
    jt = jtrn.DataParallelTrainer(jloss, JT.sgd_lr(0.05), mesh=_ref_mesh())
    jt.fit(jt.init_state(params), [JDataSet(*b) for b in data])
    tt = _trainer()
    tt.fit(tt.init_state(params), [DataSet(*b) for b in data])
    jc = {k for k in JMETRICS.snapshot()["counters"]
          if k.startswith("train_step")}
    tc = {k for k in METRICS.snapshot()["counters"]
          if k.startswith("train_step")}
    assert tc == jc
    assert {"train_step", "train_step.execute", "train_step.compile",
            "train_step.resolve_wait"} <= set(METRICS.snapshot()["timers"])
