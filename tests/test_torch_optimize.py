"""The port's gradient transforms and schedules against the JAX package's,
value by value, on trees made with numpy from a seed (float32 on both
sides: the two differ in rounding only)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.optimize import transforms as JT
from deeplearning4j_tpu_torch.optimize import transforms as TT
from deeplearning4j_tpu_torch.utils import tree_math as tm

# a few f32 ops per element
TOL = 1e-6


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32),
            "layers": [{"k": rng.standard_normal((2, 2, 2)).astype(np.float32),
                        "s": rng.standard_normal(5).astype(np.float32)}]}


def _to_torch(tree):
    return tm.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_trees_close(t_tree, j_tree, tol=TOL):
    a = [x.numpy() for x in tm.tree_leaves(t_tree)]
    b = [np.asarray(x) for x in jax.tree_util.tree_leaves(j_tree)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=tol, rtol=tol)


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (1e-4, 10, 1000)),
    ("warmup_cosine", (3e-3, 3, 20, 1e-4)),
    ("warmup_linear", (2e-5, 4, 30)),
    ("warmup_linear", (1.0, 0, 10, 0.5)),
])
def test_schedules_match_jax_value_by_value(name, args):
    js, ts = getattr(JT, name)(*args), getattr(TT, name)(*args)
    for step in list(range(0, 40)) + [999, 1000, 5000]:
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=0, err_msg=f"step {step}")
    assert TT.constant_schedule(0.1)(7) == float(JT.constant_schedule(0.1)(7))


def test_decay_leaf_mask_default_override_and_threads():
    params = _to_torch(_tree(0))
    mask = TT.decay_leaf_mask(params)
    assert mask == {"w": True, "b": False,
                    "layers": [{"k": True, "s": False}]}
    assert mask == jax.tree_util.tree_map(
        bool, JT.decay_leaf_mask(_to_jax(_tree(0))))
    flipped = tm.tree_map(lambda m: not m, mask)
    seen = {}

    def other():
        seen["other"] = TT.decay_leaf_mask(params)

    with TT.decay_mask_override(flipped):
        assert TT.decay_leaf_mask(params) == flipped
        th = threading.Thread(target=other)
        th.start()
        th.join()
        with TT.decay_mask_override(None):
            assert TT.decay_leaf_mask(params) == mask
    assert seen["other"] == mask and TT.decay_leaf_mask(params) == mask


@pytest.mark.parametrize("name", ["adamw", "adam", "momentum", "adagrad",
                                  "clip", "sgd"])
def test_transform_updates_match_jax_over_steps(name):
    make = {
        "adamw": lambda M: M.adamw(M.warmup_cosine(1e-2, 2, 10),
                                   weight_decay=0.1),
        "adam": lambda M: M.adam(3e-3),
        "momentum": lambda M: M.chain(M.momentum(0.9, {2: 0.5}),
                                      M.sgd_lr(0.1)),
        "adagrad": lambda M: M.adagrad(0.05),
        "clip": lambda M: M.chain(M.clip_by_global_norm(0.5), M.sgd_lr(1.0)),
        "sgd": lambda M: M.chain(M.identity(), M.scale(-2.0)),
    }[name]
    jtx, ttx = make(JT), make(TT)
    jp, tp = _to_jax(_tree(1)), _to_torch(_tree(1))
    js, ts = jtx.init(jp), ttx.init(tp)
    for it in range(4):
        g = _tree(10 + it)
        ju, js = jtx.update(_to_jax(g), js, jp, it)
        tu, ts = ttx.update(_to_torch(g), ts, tp, it)
        _assert_trees_close(tu, ju)
        jp, tp = JT.apply_updates(jp, ju), TT.apply_updates(tp, tu)
        _assert_trees_close(tp, jp)
    # the state mirrors the params in f32, leaf for leaf
    for a, b in zip(tm.tree_leaves(ts), jax.tree_util.tree_leaves(js)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape


def test_state_is_f32_for_bf16_params_and_updates_are_new_tensors():
    tp = tm.tree_map(lambda a: torch.from_numpy(a).bfloat16(), _tree(2))
    tx = TT.adamw(1e-3)
    state = tx.init(tp)
    assert all(s.dtype == torch.float32 for s in tm.tree_leaves(state))
    g = tm.tree_map(torch.ones_like, tp)
    before = [s.clone() for s in tm.tree_leaves(state)]
    upd, new_state = tx.update(g, state, tp, 0)
    new_p = TT.apply_updates(tp, upd)
    assert all(p.dtype == torch.bfloat16 for p in tm.tree_leaves(new_p))
    for a, b in zip(before, tm.tree_leaves(state)):
        assert torch.equal(a, b)                 # the input state untouched
    assert not torch.equal(tm.tree_leaves(new_state)[0],
                           tm.tree_leaves(state)[0])


def test_tree_math_matches_jax():
    from deeplearning4j_tpu.utils import tree_math as jtm
    a, b = _tree(3), _tree(4)
    np.testing.assert_allclose(float(tm.dot(_to_torch(a), _to_torch(b))),
                               float(jtm.dot(_to_jax(a), _to_jax(b))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm.norm2(_to_torch(a))),
                               float(jtm.norm2(_to_jax(a))), rtol=1e-6)
    _assert_trees_close(tm.clip_by_global_norm(_to_torch(a), 1.0),
                        jtm.clip_by_global_norm(_to_jax(a), 1.0))
    leaves = tm.tree_leaves(_to_torch(a))
    back = tm.tree_unflatten(a, leaves)
    assert list(back) == list(a) and len(tm.tree_leaves(((), a))) == 4
