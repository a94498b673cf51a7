"""The port's GPipe pipeline over pp against the JAX package, over gloo CPU
ranks.

The reference's ``tests/test_pipeline.py`` fixtures (its ``_cfg``:
vocab 64, 8 dims a head, float32, no remat) on meshes cut to four ranks
(``tests/torch_ranks.py``: one pool for the module): pp2, pp2·tp2,
pp2·sp2 and pp2·dp2.  Each step is held against the reference's
``PipelinedTransformerLM`` on the same mesh over ``jax.devices()[:n]``
(1e-5 absolute, float32, under SGD with momentum: the data-parallel
tests' window) and against the port's one-device step (the reference's
1e-5 absolute and ``rtol=1e-4``).  Under AdamW (ZeRO-1 against the
replicated step) the port is held within itself at the reference's 2e-4.
"""

import jax
import numpy as np
import pytest

import torch_mp_ref as R
from deeplearning4j_tpu.models import pipeline as jpl
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.optimize import transforms as JT
from deeplearning4j_tpu.parallel.checkpoint import CheckpointManager as JMgr
from torch_ranks import TXS, RankPool

WORLD = 4
RTOL = 1e-4       # the reference's pipeline parity window, with 1e-5 abs


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _cfg(n_heads=4, n_layers=4, seq=16):
    return dict(vocab_size=64, d_model=8 * n_heads, n_heads=n_heads,
                n_layers=n_layers, d_ff=64, max_len=seq, causal=True,
                remat=False)


def _unstack(tree, n_layers):
    out = dict(tree)
    if "backbone" in out:
        out["backbone"] = _unstack(out["backbone"], n_layers)
        return out
    return R.np_tree(jpl.unstack_layers(tree, n_layers))


def _pipelined(pool, spec, cfg, batches, n_micro, tx="momentum",
               finetune=False, **kw):
    """The port's pipelined steps and the reference's on ``spec``, held
    together; the port's result (its params stacked)."""
    stacked = R.init_np(cfg, seed=0, n_classes=3 if finetune else 0,
                        stacked=True)
    res = pool.run("mp_train", spec, stacked, batches, cfg, tx=tx,
                   n_micro=n_micro, finetune=finetune, timeout=120, **kw)
    got = res[0]
    jl, jp = R.jax_train(spec, stacked, batches, cfg, tx=tx,
                         n_micro=n_micro, finetune=finetune, **kw)
    R.close(got["losses"], jl, what="losses vs reference")
    R.close_trees(got["params"], jp, what="params vs reference")
    return got


def _vs_one_device(got, cfg, batches, tx="momentum", finetune=False):
    flat = R.init_np(cfg, seed=0, n_classes=3 if finetune else 0)
    ol, op = R.port_one_device(flat, batches, cfg, tx=tx, finetune=finetune)
    R.close(got["losses"], ol, R.TOL, RTOL, "losses vs one device")
    R.close_trees(_unstack(got["params"], cfg["n_layers"]), op, R.TOL, RTOL,
                  "params vs one device")


@pytest.mark.parametrize("spec,n_micro,batch,tx", [
    ({"dp": 1, "pp": 2}, 4, 8, "momentum"),
    ({"dp": 1, "pp": 2, "tp": 2}, 2, 8, "momentum"),
    ({"dp": 1, "pp": 2, "sp": 2}, 2, 4, "sgd"),
    ({"dp": 2, "pp": 2}, 2, 8, "momentum")],
    ids=["pp2", "pp2tp2", "pp2sp2", "pp2dp2"])
def test_pipelined_step_parity(pool, spec, n_micro, batch, tx):
    """Fill/drain over 2 stages, composed with tp, sp or dp: the same
    step as the reference's pipeline and as the port's one device."""
    cfg = _cfg(n_layers=4 if spec.get("tp", 1) == 1 else 2)
    batches = R.lm_batches(cfg, batch, 16)
    got = _pipelined(pool, spec, cfg, batches, n_micro, tx=tx)
    _vs_one_device(got, cfg, batches, tx=tx)


def test_pp2_finetune_parity_with_single_device(pool):
    """Classifier fine-tune through the pipeline at pp2·tp2: backbone and
    head against the reference's and the one-device fine-tune."""
    cfg = _cfg(n_layers=4)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 64, (8, 16)).astype(np.int32)
    batches = [(toks, rng.integers(0, 3, (8,)).astype(np.int32))]
    got = _pipelined(pool, {"dp": 1, "pp": 2, "tp": 2}, cfg, batches, 2,
                     finetune=True)
    _vs_one_device(got, cfg, batches, finetune=True)


def test_pp_forward_matches_single_device(pool):
    """The pipelined forward's logits, replicated to every pp rank and
    gathered over dp, against the one-device forward (the reference's
    2e-4 / 1e-3)."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.models.convert import params_from_numpy

    cfg = _cfg(n_layers=2)
    toks = R.lm_batches(cfg, 4, 16)[0][0]
    res = pool.run("pp_forward", {"dp": 2, "pp": 2},
                   R.init_np(cfg, seed=0, stacked=True), toks, cfg, 2)
    flat = params_from_numpy(R.init_np(cfg, seed=0), "cpu")
    want = ttr.TransformerLM(ttr.TransformerConfig(dtype=torch.float32,
                                                   **cfg),
                             device="cpu").forward(flat, toks).numpy()
    for r in range(WORLD):
        R.close(res[r], want, 2e-4, 1e-3, f"rank {r}")


def test_pp2_dp2_zero1_matches_replicated_pipelined_step(pool):
    """ZeRO-1 composed with pp: dp-split state with a pp row dimension
    takes the replicated pipelined step's two AdamW steps (2e-4, the
    reference's); each rank's state chunk is 1/dp of its stage block; and
    under SGD with momentum it equals the reference's pipelined ZeRO-1."""
    cfg = _cfg(n_layers=2)
    batches = R.lm_batches(cfg, 8, 16, steps=2)
    stacked = R.init_np(cfg, seed=0, stacked=True)
    spec = {"dp": 2, "pp": 2}
    z1, rep = (pool.run("mp_train", spec, stacked, batches, cfg, tx="adamw",
                        zero1=z, n_micro=2)[0] for z in (True, False))
    R.close(z1["losses"], rep["losses"], R.ATOL_MESH, R.RTOL_MESH)
    R.close_trees(z1["params"], rep["params"], R.ATOL_MESH, R.RTOL_MESH)
    # a rank's block of the stacked w1 (2, 32, 64) is one layer: 2048
    # values, its chunk 1024; the replicated tok_embed (64, 32): 1024
    assert (1, 1024) in set(z1["state_shapes"])
    assert all(s[0] == 1 for s in z1["state_shapes"])
    _pipelined(pool, spec, cfg, batches, 2, zero1=True)


def test_pp_zero1_checkpoint_resume_parity(pool, tmp_path):
    """The pp-row ZeRO-1 state in the reference's global on-disk layout:
    saved after one step (gathered to the first rank), it resumes on the
    same mesh as the uninterrupted run, restores into the JAX package's
    pipeline and into the port's one-device ``TransformerLM``, each of
    which takes the same two next steps."""
    cfg = _cfg(n_layers=2)
    batches = R.lm_batches(cfg, 8, 16, steps=3, seed=11)
    stacked = R.init_np(cfg, seed=0, stacked=True)
    spec = {"dp": 2, "pp": 2}
    kw = dict(tx="momentum", zero1=True, n_micro=2)
    first = pool.run("mp_train", spec, stacked, batches[:1], cfg,
                     ckpt=str(tmp_path), **kw)[0]
    straight = pool.run("mp_train", spec, stacked, batches, cfg, **kw)[0]
    R.close(first["losses"], straight["losses"][:1], atol=0)
    resumed = pool.run("mp_train", spec, stacked, batches[1:], cfg,
                       resume=str(tmp_path), **kw)[0]
    assert resumed["count"] == 3
    R.close(resumed["losses"], straight["losses"][1:], atol=0)
    R.close_trees(resumed["params"], straight["params"], atol=0)

    # the reference restores the port's files and continues
    jcfg = jtr.TransformerConfig(dtype=jax.numpy.float32, **cfg)
    jmesh = R.jmake(R.JSpec(**spec), devices=jax.devices()[:4])
    jm = jpl.PipelinedTransformerLM(jcfg, jmesh, n_micro=2)
    tx = TXS["momentum"](JT)
    tmpl_p = R.np_tree(jm.init(jax.random.key(0)))
    z1_tmpl, _ = jm._z1_template_and_specs(tmpl_p, jm._specs())
    tmpl_o = R.np_tree((jax.numpy.zeros((), jax.numpy.int32),
                        tx.init(z1_tmpl)))
    r = JMgr(tmp_path).restore(tmpl_p, tmpl_o)
    assert r["step"] == 1
    p, o = jm.place(r["params"]), jm.place(r["tstate"], jm.opt_specs_zero1(tx))
    step = jm.build_train_step(tx, zero1=True)
    jl = []
    for a, b in batches[1:]:
        p, o, loss = step(p, o, a, b)
        jl.append(float(loss))
    R.close(jl, straight["losses"][1:])
    R.close_trees(R.np_tree(p), straight["params"])

    # and the port's one-device model continues from the same files
    solo = pool.run("pp_one_device", str(tmp_path), spec, cfg, 2,
                    batches[1:])[0]
    assert solo["count"] == 3
    R.close(solo["losses"], straight["losses"][1:], R.TOL, RTOL)
    R.close_trees(solo["params"], _unstack(straight["params"], 2), R.TOL,
                  RTOL)


def test_stack_unstack_roundtrip_and_convert():
    """``stack_layers`` equals the reference's on the same numpy tree;
    ``unstack_layers`` inverts it; ``models.convert`` carries a stacked
    tree both ways."""
    import torch

    from deeplearning4j_tpu_torch.models import pipeline as tpl
    from deeplearning4j_tpu_torch.models.convert import (params_from_numpy,
                                                         params_to_numpy)

    cfg = _cfg()
    flat = R.init_np(cfg, seed=0)
    tree = params_from_numpy(flat, "cpu")
    st = tpl.stack_layers(tree)
    R.close_trees(params_to_numpy(st), R.np_tree(jpl.stack_layers(flat)),
                  atol=0)
    back = tpl.unstack_layers(params_from_numpy(params_to_numpy(st), "cpu"),
                              cfg["n_layers"])
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(back)),
                    jax.tree_util.tree_leaves(flat)):
        assert np.array_equal(a, b)
    assert isinstance(st["layers"]["w1"], torch.Tensor)
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    specs = tpl.pipeline_param_specs(TransformerConfig(**cfg))
    assert repr(specs["layers"]["wqkv"]) == "P('pp', None, None, 'tp', None)"


def test_layer_count_and_decode_guards(pool):
    """n_layers not divisible by pp is refused (the reference asserts);
    sample / beam_search / score on the stacked layout point at the
    unstack interchange, and that path samples."""
    cfg = _cfg(n_layers=2)
    out = pool.run("pp_guards", cfg)[0]
    assert "n_layers 3 % pp 2" in out["indivisible"]
    for name in ("sample", "beam_search", "score"):
        assert "unstack" in out[name]
    assert len(out["sampled"]) == 6
    with pytest.raises(AssertionError):
        jpl.PipelinedTransformerLM(
            jtr.TransformerConfig(**dict(cfg, n_layers=3)),
            R.jmake(R.JSpec(dp=1, pp=2), devices=jax.devices()[:2]))
