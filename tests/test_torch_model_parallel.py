"""The port's tensor- and sequence-parallel training against the JAX
package, over gloo CPU ranks.

One pool of four gloo ranks for the module (``tests/torch_ranks.py``);
each case runs the reference's fixture (``tests/test_transformer.py``:
the tiny f32 config, its optimizers and meshes cut to four ranks) through
the port's ranks and through the JAX package on the same mesh over
``jax.devices()[:n]``, and through the port's one-device step.

Tolerances (float32): the port against the JAX package on the same mesh,
1e-5 absolute on losses and params (the data-parallel tests' window:
the packages round their reductions in other orders), under SGD with
momentum; the port's
mesh against its one device, the reference's own ``rtol=2e-4`` /
``atol=2e-4`` (``tests/test_transformer.py:149-153``), under the
reference's AdamW.  (AdamW's first step is ~lr * sign(g): it turns the
rounding of a near-zero gradient into a whole step of lr = 0.1, so
across packages it is held on the losses only — measured 1.7e-5 on one
of 2048 w1 entries at dp2·tp2.)
"""

import jax
import numpy as np
import pytest

import torch_mp_ref as R
from deeplearning4j_tpu.parallel import collectives as jc
from torch_ranks import RankPool

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

WORLD = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _run(pool, spec, params, batches, cfg, **kw):
    res = pool.run("mp_train", spec, params, batches, cfg, timeout=120, **kw)
    n = int(np.prod(list(spec.values())))
    for r in range(1, n):           # every member ends with the same tree
        R.close(res[r]["losses"], res[0]["losses"], atol=0)
    return res[0]


def _ref_leaves(tree):
    """The leaves the reference's mesh-vs-one-device checks read:
    ``layers[0]["w1"]`` and ``tok_embed``."""
    tree = tree.get("backbone", tree)
    return [tree["layers"][0]["w1"], tree["tok_embed"]]


def _held(pool, spec, params, batches, cfg, tx, **kw):
    """Under the reference's optimizer ``tx``: the port's mesh against its
    one device on the loss and the reference's leaves, and against the
    reference's mesh on the loss.  Under SGD with momentum: every param
    against the reference's mesh (1e-5) and the port's one device."""
    got = _run(pool, spec, params, batches, cfg, tx=tx, **kw)
    jl, _ = R.jax_train(spec, params, batches, cfg, tx=tx, **kw)
    R.close(got["losses"], jl, what="losses vs reference")
    ol, op = R.port_one_device(params, batches, cfg, tx=tx, **kw)
    R.close(got["losses"], ol, R.ATOL_MESH, R.RTOL_MESH, "losses vs one")
    R.close_trees(_ref_leaves(got["params"]), _ref_leaves(op), R.ATOL_MESH,
                  R.RTOL_MESH, "vs one")
    if tx != "momentum":
        got = _run(pool, spec, params, batches, cfg, tx="momentum", **kw)
        ol, op = R.port_one_device(params, batches, cfg, tx="momentum", **kw)
    jl, jp = R.jax_train(spec, params, batches, cfg, tx="momentum", **kw)
    R.close(got["losses"], jl, what="momentum losses vs reference")
    R.close_trees(got["params"], jp, what="params vs reference")
    R.close_trees(got["params"], op, R.ATOL_MESH, R.RTOL_MESH,
                  "momentum vs one")


@pytest.mark.parametrize("spec", [
    {"dp": 2, "tp": 2}, {"dp": 1, "sp": 2, "tp": 2}, {"dp": 1, "sp": 4},
    {"dp": 4}], ids=["dp2tp2", "sp2tp2", "sp4", "dp4"])
def test_sharded_step_matches_single_device(pool, spec):
    """dp/sp/tp step (ring attention, Megatron tp psums, the dp gradient
    mean) with AdamW state: against the reference on the same mesh, and
    against the port's one-device step."""
    cfg = R.tiny()
    params = R.init_np(cfg)
    batches = R.lm_batches(cfg, 8, 16)
    _held(pool, spec, params, batches, cfg, "adamw_cosine")


def test_long_context_ring_attention_sp4(pool):
    """Seq 1024 over an sp=4 ring (256 tokens a rank): the blockwise
    running softmax is exact against the one-device step, and the port
    equals the reference's ring."""
    cfg = R.tiny(max_len=1024)
    params = R.init_np(cfg)
    batches = R.lm_batches(cfg, 2, 1024, seed=3)
    spec = {"dp": 1, "sp": 4}
    _held(pool, spec, params, batches, cfg, "sgd")


def test_zero1_step_matches_replicated_step(pool):
    """ZeRO-1 at dp2·tp2 (reduce-scatter over dp of the tp-local blocks):
    two AdamW steps equal the replicated step's and the reference's
    ZeRO-1 step's; each rank's state chunk is 1/dp of its tp block."""
    cfg = R.tiny(causal=False)
    params = R.init_np(cfg)
    batches = R.lm_batches(cfg, 8, 16, steps=2, seed=5)
    spec = {"dp": 2, "tp": 2}
    z1 = _run(pool, spec, params, batches, cfg, tx="adamw", zero1=True)
    rep = _run(pool, spec, params, batches, cfg, tx="adamw")
    R.close(z1["losses"], rep["losses"], R.ATOL_MESH, R.RTOL_MESH)
    R.close_trees(z1["params"], rep["params"], R.ATOL_MESH, R.RTOL_MESH)
    jl, _ = R.jax_train(spec, params, batches, cfg, tx="adamw", zero1=True)
    R.close(z1["losses"][:1], jl[:1])
    assert z1["count"] == 2
    # across the packages under SGD with momentum, losses and params
    m1 = _run(pool, spec, params, batches, cfg, tx="momentum", zero1=True)
    jl, jp = R.jax_train(spec, params, batches, cfg, tx="momentum",
                         zero1=True)
    R.close(m1["losses"], jl)
    R.close_trees(m1["params"], jp)
    # wqkv (32, 3, 4, 8) splits its heads over tp: a rank's block is 1536
    # values, its chunk 768; the replicated tok_embed (64, 32) gives 1024
    shapes = set(z1["state_shapes"])
    assert (1, 768) in shapes and (1, 1024) in shapes


def test_finetune_sharded_matches_single(pool):
    """Classifier fine-tune at dp2·tp2 with AdamW state: against the
    reference's and the port's one-device fine-tune."""
    cfg = R.tiny(causal=False)
    params = R.init_np(cfg, n_classes=2)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 64, (8, 16)).astype(np.int32)
    batches = [(toks, (toks == 7).any(axis=1).astype(np.int32))]
    spec = {"dp": 2, "tp": 2}
    _held(pool, spec, params, batches, cfg, "adamw", finetune=True)


def _jax_collectives(axis, n):
    mesh = R.jmake(R.JSpec(**{"dp": 1, axis: n}),
                   devices=jax.devices()[:n])
    from jax.sharding import PartitionSpec as JP

    def f(x):
        r = jc.axis_index(axis)
        x = x[0] * (r + 1) + 10 * r
        return (jc.psum(x, axis)[None], jc.pmean(x, axis)[None],
                jc.all_gather(x, axis)[None],
                jc.ring_shift(x, axis, n, 1)[None],
                jc.ppermute(x, axis, [(i, (i - 1) % n)
                                      for i in range(n)])[None])

    x = np.tile(np.arange(8, dtype=np.float32), (n, 1))
    out = shard_map(f, mesh=mesh, in_specs=(JP(axis),),
                    out_specs=(JP(axis),) * 5)(x)
    names = ("psum", "pmean", "all_gather", "ring_shift", "ppermute_back")
    return {k: np.asarray(v) for k, v in zip(names, out)}


@pytest.mark.parametrize("spec", [{"dp": 1, "tp": 2, "sp": 2},
                                  {"dp": 1, "sp": 4}],
                         ids=["sp2tp2", "sp4"])
def test_collectives_over_tp_and_sp(pool, spec):
    """Each collective over a named tp or sp axis reaches that axis's
    line only, as the reference's inside ``shard_map``
    (``tests/test_parallel.py:46,64``); ppermute's gradient is the
    inverse rotation, and the tp pair's backward is a psum of the
    cotangent."""
    res = pool.run("mp_collectives", spec)
    for axis, n in spec.items():
        if n == 1:
            continue
        want = _jax_collectives(axis, n)
        for r in range(WORLD):
            got = res[r][axis]
            i = int(got["axis_index"])
            for k, v in want.items():
                R.close(got[k], v[i], atol=0, what=f"{axis} {k} rank {r}")
            x = np.arange(8, dtype=np.float32)
            xs = [x * (j + 1) + 10 * j for j in range(n)]
            # d/dw of sum_j (j+1) * ppermute(w*w)_j: rank i's square lands
            # on rank i+1, scaled by (i+2)
            R.close(got["ppermute_grad"], 2 * xs[i] * ((i + 1) % n + 1),
                    what=f"{axis} ppermute grad")
            # rank j's cotangent into copy_to_tp is (j+1) * x_j: its
            # backward psums them over the line, on every rank alike
            R.close(got["tp_pair_grad"],
                    sum((j + 1) * xs[j] for j in range(n)),
                    what=f"{axis} tp pair grad")


def test_gqa_under_tp_raises(pool):
    """GQA trees stay replicated and do not shard over tp, as in the
    reference (which asserts): the port's step raises on every rank.
    (Last in the module: the failed job restarts the pool.)"""
    cfg = R.tiny(n_kv_heads=2)
    params = R.init_np(cfg)
    batches = R.lm_batches(cfg, 4, 16)
    with pytest.raises(AssertionError, match="GQA"):
        pool.run("mp_train", {"dp": 2, "tp": 2}, params, batches, cfg)
    with pytest.raises(AssertionError, match="GQA"):
        R.jax_train({"dp": 2, "tp": 2}, params, batches, cfg)
