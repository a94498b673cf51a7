"""The port's ResNet (``deeplearning4j_tpu_torch.models.resnet``) against
the JAX package's, on the CPU in float32.

The weights come from the reference's ``init_params(jax.random.key(0),
ResNetConfig.resnet18(num_classes=5, width=8, dtype=float32))`` and move
across through numpy (``models.convert``) unchanged: the same tree, NHWC
images and HWIO kernels in both packages.

Tolerances.  Each layer on the same inputs (the stem and every
bottleneck, stride-2 SAME padding included) agrees within 1e-5, the loss
and the running statistics after one forward within 1e-5.  Logits and
gradients are held within 1e-4 of each leaf's scale: the two packages
compute each BatchNorm's f32 variance in a different summation order,
and 8 bottlenecks grow those last-bit differences past 1e-5.  Both
packages' f32 logits are also held within 1e-4 of the port's forward in
float64 throughout: the gap is f32 rounding on both sides, not a
difference in the function.  Then
the four tests of ``tests/test_resnet_bn.py`` and the s2d-stem test of
``tests/test_models_utils.py`` as the port's own, three
``train_step``\\ s with ``chain(momentum(0.9), sgd_lr(1e-2))`` against the
reference's, and ``flops_per_image`` equal for ResNet-18 and ResNet-50.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import resnet as R
from deeplearning4j_tpu.optimize import transforms as JT
from deeplearning4j_tpu_torch.models import resnet as T
from deeplearning4j_tpu_torch.models.convert import (params_from_numpy,
                                                      params_to_numpy)
from deeplearning4j_tpu_torch.optimize import transforms as TT
from deeplearning4j_tpu_torch.utils.autodiff import value_and_grad
from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves

CPU = "cpu"
TOL = 1e-5          # layers on the same inputs, loss, running stats
TOL_SCALED = 1e-4   # logits and gradients, of each leaf's max |value|


def _cfgs(**kw):
    return (R.ResNetConfig.resnet18(num_classes=5, width=8,
                                    dtype=jnp.float32, **kw),
            T.ResNetConfig.resnet18(num_classes=5, width=8,
                                    dtype=torch.float32, **kw))


def _data(n=8, size=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    return x, y


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = _cfgs()
    jp = R.init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device=CPU)
    return jcfg, tcfg, jp, tp


def _np(t):
    return t.detach().cpu().numpy()


def _close_scaled(got, want, tol=TOL_SCALED):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), (err, np.abs(want).max())


def _f64(tree):
    return params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), params_to_numpy(tree)), device=CPU)


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


# --------------------------------------------------------------------------- the tree

def test_parameter_trees_have_the_reference_shapes():
    jcfg, tcfg = _cfgs()
    jp = R.init_params(jax.random.key(0), jcfg)
    tp = T.init_params(torch.Generator().manual_seed(0), tcfg, device=CPU)
    js = jax.tree_util.tree_map(lambda a: a.shape, jp)
    ts = jax.tree_util.tree_map(lambda a: tuple(a.shape), params_to_numpy(tp))
    assert js == ts
    assert jax.tree_util.tree_structure(R.init_batch_stats(jcfg)) == \
        jax.tree_util.tree_structure(params_to_numpy(
            T.init_batch_stats(tcfg, device=CPU)))
    # He init: the stem kernel's std is sqrt(2 / fan_in)
    std = float(tp["stem"]["conv"].std())
    assert abs(std - np.sqrt(2.0 / (7 * 7 * 3))) < 0.02
    # the port's tree runs in the reference unchanged
    back = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tp))
    x, _ = _data()
    _close_scaled(_np(T.forward(tp, torch.from_numpy(x), tcfg)),
                  R.forward(back, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("depth", ["resnet18", "resnet50"])
def test_flops_per_image_equal_the_reference(depth):
    for size in (224, 64):
        assert getattr(T.ResNetConfig, depth)().flops_per_image(size) == \
            getattr(R.ResNetConfig, depth)().flops_per_image(size)


# --------------------------------------------------------------------------- forward and gradients

def test_each_layer_on_the_same_inputs_equals_the_reference(carried):
    jcfg, tcfg, jp, tp = carried
    x, _ = _data()
    w = R._stem_s2d_kernel(jp["stem"]["conv"])
    h = jax.lax.conv_general_dilated(
        R._space_to_depth(jnp.asarray(x)), w, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ht = T._conv_oihw(T._nchw(T._space_to_depth(torch.from_numpy(x))),
                      T._kernel(T._stem_s2d_kernel(tp["stem"]["conv"]),
                                torch.float32), 1, torch.float32)
    np.testing.assert_allclose(_nhwc(ht), np.asarray(h), atol=TOL)
    yr, _ = R._bn(h, jp["stem"]["bn"])
    yt, _ = T._bn(_nchw(h), tp["stem"]["bn"])
    np.testing.assert_allclose(_nhwc(yt), np.asarray(yr), atol=TOL)
    xr = jax.lax.reduce_window(jax.nn.relu(yr), -jnp.inf, jax.lax.max,
                               (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    from deeplearning4j_tpu_torch.ops.convolution import max_pool
    xt = max_pool(torch.relu(_nchw(yr)), (3, 3), (2, 2), "SAME")
    np.testing.assert_array_equal(_nhwc(xt), np.asarray(xr))
    for s, stage in enumerate(jp["stages"]):
        for b, blk in enumerate(stage):
            stride = 2 if (s > 0 and b == 0) else 1
            a, _ = R._bottleneck(xr, blk, stride, jnp.float32)
            bt, _ = T._bottleneck(_nchw(xr), tp["stages"][s][b], stride,
                                  torch.float32)
            assert bt.is_contiguous(memory_format=torch.channels_last)
            np.testing.assert_allclose(_nhwc(bt), np.asarray(a), atol=TOL,
                                       err_msg=f"block {s}.{b}")
            xr = a


def test_same_padding_of_a_stride_2_conv_on_an_even_input():
    """XLA pads a 3x3 stride-2 SAME conv (0, 1) on an even size; the port
    follows it, where F.conv2d(padding=1) would pad (1, 1)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = T._conv(_nchw(x), torch.from_numpy(w), 2, torch.float32)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
    naive = torch.nn.functional.conv2d(_nchw(x), torch.from_numpy(w).permute(
        3, 2, 0, 1), stride=2, padding=1)
    assert np.abs(_nhwc(naive) - np.asarray(want)).max() > 1e-2


def test_logits_loss_gradients_and_stats_equal_the_reference(carried):
    jcfg, tcfg, jp, tp = carried
    x, y = _data()
    jl = R.forward(jp, jnp.asarray(x), jcfg)
    tl = T.forward(tp, torch.from_numpy(x), tcfg)
    _close_scaled(_np(tl), jl)
    cfg64 = dataclasses.replace(tcfg, dtype=torch.float64,
                                param_dtype=torch.float64)
    exact = _np(T.forward(_f64(tp), torch.from_numpy(x).double(), cfg64))
    _close_scaled(_np(tl), exact)
    _close_scaled(np.asarray(jl), exact)
    jloss, jg = jax.value_and_grad(R.cross_entropy)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    tloss, tg = value_and_grad(T.cross_entropy)(
        tp, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    assert abs(float(tloss) - float(jloss)) < TOL
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == 89
    for a, b in zip(jleaves, tleaves):
        _close_scaled(_np(b), a)
    _, jst = R.forward(jp, jnp.asarray(x), jcfg, R.init_batch_stats(jcfg))
    _, tst = T.forward(tp, torch.from_numpy(x), tcfg,
                       T.init_batch_stats(tcfg, device=CPU))
    for a, b in zip(jax.tree_util.tree_leaves(jst), tree_leaves(tst)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=TOL)


def test_eval_mode_equals_the_reference(carried):
    jcfg, tcfg, jp, tp = carried
    x, _ = _data(n=4, seed=2)
    rng = np.random.default_rng(9)
    jst = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.random(a.shape).astype(
            np.float32) * 0.5), R.init_batch_stats(jcfg))
    tst = params_from_numpy(jax.tree_util.tree_map(np.asarray, jst),
                            device=CPU)
    jl, _ = R.forward(jp, jnp.asarray(x), jcfg, jst, train=False)
    tl, back = T.forward(tp, torch.from_numpy(x), tcfg, tst, train=False)
    _close_scaled(_np(tl), jl)
    for a, b in zip(tree_leaves(back), tree_leaves(tst)):
        assert a is b                      # eval mode hands the stats back
    with pytest.raises(ValueError, match="running stats"):
        T._bn(_nchw(x), tp["stem"]["bn"], None, train=False)


def test_three_train_steps_equal_the_reference(carried):
    """Three steps of ``chain(momentum(0.9), sgd_lr(1e-2))`` from the same
    weights: each loss within 1e-4 of the reference's, the parameters and
    running stats within 2e-3 of the reference's and of the same steps
    run in float64 throughout (the port's model at float64; the steps
    move the parameters by more than 0.05, asserted below; f32 rounding
    alone moves each package's parameters off the float64 run by less
    than the tolerance).  Batch 32: at batch 8 the last stage normalizes over 8
    values (1x1 spatial), and three steps amplify f32 rounding in the
    losses of both packages far past these tolerances."""
    jcfg, tcfg, jp, tp = carried
    x, y = _data(n=32)
    jtx = JT.chain(JT.momentum(0.9), JT.sgd_lr(1e-2))
    ttx = TT.chain(TT.momentum(0.9), TT.sgd_lr(1e-2))
    jm, tm = R.ResNet(jcfg), T.ResNet(tcfg, device=CPU)
    jstep, tstep = jm.train_step(jtx), tm.train_step(ttx)
    jstate = (jax.tree_util.tree_map(jnp.copy, jp), R.init_batch_stats(jcfg),
              (jnp.zeros((), jnp.int32), jtx.init(jp)))
    tstate = (tp, T.init_batch_stats(tcfg, device=CPU), (0, ttx.init(tp)))
    cfg64 = dataclasses.replace(tcfg, dtype=torch.float64,
                                param_dtype=torch.float64)
    step64 = T.ResNet(cfg64, device=CPU).train_step(ttx)
    p64 = _f64(tp)
    state64 = (p64, _f64(T.init_batch_stats(tcfg, device=CPU)),
               (0, ttx.init(p64)))
    for _ in range(3):
        *jstate, jloss = jstep(*jstate, jnp.asarray(x), jnp.asarray(y))
        *tstate, tloss = tstep(*tstate, torch.from_numpy(x),
                               torch.from_numpy(y))
        *state64, loss64 = step64(*state64, torch.from_numpy(x).double(),
                                  torch.from_numpy(y).double())
        assert abs(float(tloss) - float(jloss)) < 1e-4
        assert abs(float(tloss) - float(loss64)) < 1e-4
    assert tstate[2][0] == 3
    for i in (0, 1):                       # parameters, running stats
        for a, b, c in zip(jax.tree_util.tree_leaves(jstate[i]),
                           tree_leaves(tstate[i]), tree_leaves(state64[i])):
            np.testing.assert_allclose(_np(b), np.asarray(a), atol=2e-3)
            np.testing.assert_allclose(_np(b), _np(c), atol=2e-3)
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(tstate[0]), tree_leaves(tp)))
    assert moved > 0.05


def test_bf16_compute_keeps_f32_params_stats_and_head(carried):
    _, tcfg, _, tp = carried
    bcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    x, y = _data()
    xt = torch.from_numpy(x)
    logits, st = T.forward(tp, xt, bcfg, T.init_batch_stats(bcfg, device=CPU))
    assert logits.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in tree_leaves(st))
    l32 = float(T.cross_entropy(tp, xt, torch.from_numpy(y), tcfg))
    l16 = float(T.cross_entropy(tp, xt, torch.from_numpy(y), bcfg))
    assert abs(l16 - l32) < 0.02 * abs(l32), (l16, l32)
    _, g = value_and_grad(T.cross_entropy)(tp, xt, torch.from_numpy(y), bcfg)
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in tree_leaves(g))


# --------------------------------------------------------------------------- tests/test_resnet_bn.py

def test_train_mode_with_stats_matches_stateless_path(carried):
    _, cfg, _, params = carried
    stats = T.init_batch_stats(cfg, device=CPU)
    x, y = (torch.from_numpy(a) for a in _data())
    logits0 = T.forward(params, x, cfg)
    logits1, new_stats = T.forward(params, x, cfg, stats)
    np.testing.assert_allclose(_np(logits0), _np(logits1), atol=1e-6)
    l0 = T.cross_entropy(params, x, y, cfg)
    l1, _ = T.cross_entropy_with_stats(params, stats, x, y, cfg)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    assert not np.allclose(_np(new_stats["stem"]["bn"]["mean"]), 0.0)


def test_running_stats_converge_to_batch_moments(carried):
    _, cfg, _, params = carried
    stats = T.init_batch_stats(cfg, device=CPU)
    x = torch.from_numpy(_data()[0])
    with torch.no_grad():
        for _ in range(40):
            _, stats = T.forward(params, x, cfg, stats)
        w = T._kernel(T._stem_s2d_kernel(params["stem"]["conv"]), cfg.dtype)
        h = T._conv_oihw(T._nchw(T._space_to_depth(x)), w, 1, cfg.dtype)
    np.testing.assert_allclose(_np(stats["stem"]["bn"]["mean"]),
                               _np(h.float().mean(dim=(0, 2, 3))),
                               rtol=0.05, atol=0.02)


def test_eval_mode_is_batch_independent(carried):
    _, cfg, _, params = carried
    model = T.ResNet(cfg, device=CPU)
    model.init()
    model.params = params_from_numpy(params_to_numpy(params), device=CPU)
    x, y = (torch.from_numpy(a) for a in _data(n=8))
    tx = TT.chain(TT.momentum(0.9), TT.sgd_lr(1e-2))
    step = model.train_step(tx)
    opt = (0, tx.init(model.params))
    p, stats = model.params, model.batch_stats
    for _ in range(5):
        p, stats, opt, loss = step(p, stats, opt, x, y)
    model.params, model.batch_stats = p, stats
    assert np.isfinite(float(loss))
    probe = torch.from_numpy(_data(n=4, seed=3)[0])
    alone = model.predict_logits(probe[:1], use_running_stats=True)
    batched = model.predict_logits(probe, use_running_stats=True)[:1]
    np.testing.assert_allclose(_np(alone), _np(batched), rtol=1e-4, atol=1e-4)
    alone_t = model.predict_logits(probe[:1])
    batched_t = model.predict_logits(probe)[:1]
    assert not np.allclose(_np(alone_t), _np(batched_t), rtol=1e-4, atol=1e-4)


def test_bn_fold_matches_unfolded(carried):
    _, cfg, _, params = carried
    fcfg = dataclasses.replace(cfg, bn_fold=True)
    x, y = (torch.from_numpy(a) for a in _data())
    np.testing.assert_allclose(_np(T.forward(params, x, cfg)),
                               _np(T.forward(params, x, fcfg)),
                               rtol=1e-4, atol=1e-4)
    h = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 16, 16, 8)) * 3 + 1).to(torch.bfloat16).permute(0, 3, 1, 2)
    p = {"scale": torch.from_numpy(np.random.default_rng(3).random(8) + 0.5
                                   ).float(),
         "bias": torch.from_numpy(np.random.default_rng(4).random(8)).float()}
    y0, _ = T._bn(h, p, fold=False)
    y1, _ = T._bn(h, p, fold=True)
    assert y0.dtype == y1.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y0.float()), _np(y1.float()), rtol=0.05,
                               atol=0.05)
    bfcfg = dataclasses.replace(cfg, dtype=torch.bfloat16, bn_fold=True)
    _, g = value_and_grad(T.cross_entropy)(params, x, y, bfcfg)
    assert all(torch.isfinite(v).all() for v in tree_leaves(g))
    stats = T.init_batch_stats(cfg, device=CPU)
    _, ns0 = T.forward(params, x, cfg, stats)
    _, ns1 = T.forward(params, x, fcfg, stats)
    for a, b in zip(tree_leaves(ns0), tree_leaves(ns1)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)


def test_bn_fold_equals_the_reference_fold(carried):
    jcfg, tcfg, jp, tp = carried
    x, _ = _data()
    jl = R.forward(jp, jnp.asarray(x), dataclasses.replace(jcfg, bn_fold=True))
    tl = T.forward(tp, torch.from_numpy(x),
                   dataclasses.replace(tcfg, bn_fold=True))
    _close_scaled(_np(tl), jl)


# --------------------------------------------------------------------------- tests/test_models_utils.py

def test_resnet_s2d_stem_matches_plain_stem(carried):
    _, cfg, _, params = carried
    assert cfg.stem_space_to_depth
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    y_s2d = T.forward(params, x, cfg)
    y_plain = T.forward(params, x,
                        dataclasses.replace(cfg, stem_space_to_depth=False))
    np.testing.assert_allclose(_np(y_s2d), _np(y_plain), atol=2e-3)
    # the stems themselves agree to summation order
    w = T._kernel(T._stem_s2d_kernel(params["stem"]["conv"]), torch.float32)
    s2d = T._conv_oihw(T._nchw(T._space_to_depth(x)), w, 1, torch.float32)
    plain = T._conv(T._nchw(x), params["stem"]["conv"], 2, torch.float32)
    np.testing.assert_allclose(_np(s2d), _np(plain), atol=1e-5)


def test_resnet18_forward_and_grad():
    _, cfg = _cfgs()
    model = T.ResNet(cfg, device=CPU)
    model.init(torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    logits = model.predict_logits(x)
    assert logits.shape == (2, 5)
    y = torch.nn.functional.one_hot(torch.tensor([0, 3]), 5).float()
    _, g = value_and_grad(lambda p: model.loss_fn()(p, x, y))(model.params)
    flat = tree_leaves(g)
    assert all(torch.isfinite(v).all() for v in flat)
    assert any(float(v.abs().max()) > 0 for v in flat)


def test_resnet_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    for make in (lambda: T.ResNet(cfg),
                 lambda: T.init_params(torch.Generator(), cfg),
                 lambda: T.init_batch_stats(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
