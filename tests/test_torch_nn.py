"""The port's DL4J layers and configurations against the JAX package's.

Parameters are drawn by the JAX package and cross as numpy arrays
(``models.convert``).  Every layer kind's ``activate`` / ``pre_output`` /
``loss`` (and its gradients) is held to 1e-5 relative in float32.  The
stochastic steps are held on the reference's own draws: the test replays
the reference's key splits with ``jax.random`` and feeds the draws to the
port's arithmetic (``RBM._cd_k``, ``AutoEncoder._loss_from_draw``); a
Bernoulli draw is ``uniform < mean``, a categorical one the argmax of
Gumbel noise plus the log-probabilities.  The seeds below give no draw
within rounding of its threshold, so no sample flips between the
packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as JZ
from deeplearning4j_tpu.nn import conf as JCf
from deeplearning4j_tpu.nn import layers as JLy
from deeplearning4j_tpu.nn import weights as JW
from deeplearning4j_tpu_torch.models import zoo as TZ
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn import conf as TCf
from deeplearning4j_tpu_torch.nn import layers as TLy
from deeplearning4j_tpu_torch.nn import weights as TW
from deeplearning4j_tpu_torch.utils.autodiff import value_and_grad

TOL = 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(t, j, tol=TOL):
    a, b = _np(t), _np(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(b)))) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


def _close_tree(t, j, tol=TOL):
    assert sorted(t) == sorted(j)
    for k in t:
        _close(t[k], j[k], tol)


def _pair(kind, seed=0, **kw):
    """(reference layer, port layer, reference params, port params)."""
    conf = JCf.NeuralNetConfiguration(kind=JCf.LayerKind(kind), seed=seed,
                                      **kw)
    jl = JLy.create_layer(conf)
    jp = jl.init(jax.random.key(seed))
    tl = TLy.create_layer(TCf.NeuralNetConfiguration.from_json(conf.to_json()))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jl, tl, jp, tp


def _x(shape, seed=1, lo=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, 1.0, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ dense, output

@pytest.mark.parametrize("activation", ["sigmoid", "tanh", "relu", "softmax"])
def test_dense_layer_matches_jax(activation):
    jl, tl, jp, tp = _pair("dense", n_in=7, n_out=5, activation=activation)
    x = _x((6, 7))
    _close(tl.pre_output(tp, torch.from_numpy(x)),
           jl.pre_output(jp, jnp.asarray(x)))
    _close(tl.activate(tp, torch.from_numpy(x)), jl.activate(jp, jnp.asarray(x)))
    assert tl.param_order == jl.param_order and tl.output_dim() == 5


@pytest.mark.parametrize("loss,activation", [
    ("mcxent", "softmax"), ("mse", "linear"), ("xent", "sigmoid"),
    ("negativeloglikelihood", "softmax"), ("blocked_mcxent", "linear")])
def test_output_layer_loss_and_grads_match_jax(loss, activation):
    jl, tl, jp, tp = _pair("output", n_in=6, n_out=4, loss=loss,
                           activation=activation)
    x = _x((9, 6))
    y = np.eye(4, dtype=np.float32)[np.random.default_rng(2).integers(0, 4, 9)]
    jv, jg = jax.value_and_grad(jl.loss)(jp, jnp.asarray(x), jnp.asarray(y))
    tv, tg = value_and_grad(tl.loss)(tp, torch.from_numpy(x),
                                     torch.from_numpy(y))
    _close(tv, jv)
    _close_tree(tg, jg)
    _close(tl.label_probabilities(tp, torch.from_numpy(x)),
           jl.label_probabilities(jp, jnp.asarray(x)))


def test_dense_dropout_draws_from_the_generator():
    _, tl, _, tp = _pair("dense", n_in=50, n_out=3, dropout=0.5)
    x = torch.ones((40, 50))
    det = tl.activate(tp, x)
    assert torch.equal(det, tl.activate(tp, x, train=True))      # no rng
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a = tl.activate(tp, x, rng=g1, train=True)
    assert torch.equal(a, tl.activate(tp, x, rng=g2, train=True))
    assert not torch.allclose(a, det)


# ------------------------------------------------------------------ RBM

_VIS = ["binary", "gaussian", "softmax", "linear"]
_HID = ["rectified", "binary", "gaussian", "softmax"]


def _jax_draw(unit, key, shape):
    kind = TLy._NOISE[unit]
    if kind is None:
        return None
    fn = {"uniform": jax.random.uniform, "normal": jax.random.normal,
          "gumbel": jax.random.gumbel}[kind]
    return torch.tensor(np.asarray(fn(key, shape, jnp.float32)))


def _jax_cd_draws(key, vis, hid, n, n_in, n_out, k):
    """The reference's draws of one CD-k update, replaying its splits."""
    k0, kchain = jax.random.split(key)
    h0 = _jax_draw(hid, k0, (n, n_out))
    chain = []
    for kk in jax.random.split(kchain, max(k, 1)):
        kv, kh = jax.random.split(kk)
        chain.append((_jax_draw(vis, kv, (n, n_in)),
                      _jax_draw(hid, kh, (n, n_out))))
    return h0, chain


@pytest.mark.parametrize("hidden", _HID)
@pytest.mark.parametrize("visible", _VIS)
def test_rbm_cd_k_matches_jax_on_its_draws(visible, hidden):
    k = 2 if (visible, hidden) == ("binary", "binary") else 1
    n, n_in, n_out = 12, 9, 6
    jl, tl, jp, tp = _pair("rbm", n_in=n_in, n_out=n_out, k=k,
                           visible_unit=JCf.RBMVisibleUnit(visible),
                           hidden_unit=JCf.RBMHiddenUnit(hidden),
                           weight_init=JCf.WeightInit.DISTRIBUTION,
                           dist_std=0.5)
    x = (_x((n, n_in), seed=3, lo=0.0) > 0.5).astype(np.float32)
    key = jax.random.key(11)
    js, jg = jl.pretrain_value_and_grad(jp, jnp.asarray(x), key)
    draws = _jax_cd_draws(key, visible, hidden, n, n_in, n_out, k)
    ts, tg = tl._cd_k(tp, torch.from_numpy(x), draws)
    _close(ts, js)
    _close_tree(tg, jg)


def test_rbm_conditionals_and_free_energy_match_jax():
    jl, tl, jp, tp = _pair("rbm", n_in=8, n_out=5, sparsity=0.1)
    x = _x((7, 8), lo=0.0)
    T, J = torch.from_numpy, jnp.asarray
    _close(tl.prop_up(tp, T(x)), jl.prop_up(jp, J(x)))
    h = _x((7, 5), seed=4, lo=0.0)
    _close(tl.prop_down(tp, T(h)), jl.prop_down(jp, J(h)))
    _close(tl.free_energy(tp, T(x)), jl.free_energy(jp, J(x)))
    _close(tl.reconstruct(tp, T(x)), jl.reconstruct(jp, J(x)))
    # sparsity term in the hidden-bias gradient, on the reference's draws
    key = jax.random.key(2)
    js, jg = jl.pretrain_value_and_grad(jp, J(x), key)
    ts, tg = tl._cd_k(tp, T(x), _jax_cd_draws(key, "binary", "binary", 7, 8,
                                              5, 1))
    _close(ts, js)
    _close_tree(tg, jg)
    assert tl.transpose().conf.n_in == 5


def test_rbm_samples_draw_from_the_generator():
    _, tl, _, tp = _pair("rbm", n_in=8, n_out=5)
    x = torch.from_numpy(_x((7, 8), lo=0.0))
    g = torch.Generator().manual_seed(0)
    mean, sample = tl.sample_hidden_given_visible(tp, x, g)
    assert set(sample.unique().tolist()) <= {0.0, 1.0}
    v_mean, v_s, h_mean, h_s = tl.gibbs_hvh(tp, sample, g)
    assert v_s.shape == (7, 8) and h_s.shape == (7, 5)
    s1, g1 = tl.pretrain_value_and_grad(tp, x, torch.Generator().manual_seed(3))
    s2, g2 = tl.pretrain_value_and_grad(tp, x, torch.Generator().manual_seed(3))
    assert torch.equal(s1, s2) and all(torch.equal(g1[k], g2[k]) for k in g1)


# ------------------------------------------------------------------ autoencoders

@pytest.mark.parametrize("sparsity", [0.0, 0.05])
def test_autoencoder_loss_and_grads_on_the_reference_corruption(sparsity):
    jl, tl, jp, tp = _pair("autoencoder", n_in=10, n_out=4,
                           corruption_level=0.3, sparsity=sparsity)
    x = _x((8, 10), lo=0.0)
    key = jax.random.key(5)
    jv, jg = jl.pretrain_value_and_grad(jp, jnp.asarray(x), key)
    u = torch.tensor(np.asarray(jax.random.uniform(key, x.shape,
                                                   jnp.float32)))
    # the reference's mask is exactly the port's on the same draws
    np.testing.assert_array_equal(
        tl._corrupted(torch.from_numpy(x), u).numpy(),
        np.asarray(jl.corrupt(key, jnp.asarray(x))))
    tv, tg = value_and_grad(tl._loss_from_draw)(tp, torch.from_numpy(x), u)
    _close(tv, jv)
    _close_tree(tg, jg)
    T, J = torch.from_numpy, jnp.asarray
    _close(tl.reconstruct(tp, T(x)), jl.reconstruct(jp, J(x)))
    g = torch.Generator().manual_seed(0)
    v, grads = tl.pretrain_value_and_grad(tp, T(x), g)
    assert torch.isfinite(v) and sorted(grads) == ["W", "b", "vb"]


def test_autoencoder_without_corruption_matches_jax():
    jl, tl, jp, tp = _pair("autoencoder", n_in=6, n_out=3,
                           corruption_level=0.0)
    x = _x((5, 6), lo=0.0)
    jv, jg = jl.pretrain_value_and_grad(jp, jnp.asarray(x), jax.random.key(0))
    tv, tg = tl.pretrain_value_and_grad(tp, torch.from_numpy(x),
                                        torch.Generator())
    _close(tv, jv)
    _close_tree(tg, jg)


def test_recursive_autoencoder_matches_jax():
    jl, tl, jp, tp = _pair("recursive_autoencoder", n_in=5, n_out=5,
                           activation="tanh")
    x = _x((6, 5))
    jv, jg = jl.pretrain_value_and_grad(jp, jnp.asarray(x), None)
    tv, tg = tl.pretrain_value_and_grad(tp, torch.from_numpy(x), None)
    _close(tv, jv)
    _close_tree(tg, jg)
    _close(tl.activate(tp, torch.from_numpy(x)), jl.activate(jp, jnp.asarray(x)))


# ------------------------------------------------------------------ LSTM, conv, BN, embedding

@pytest.mark.parametrize("batched", [False, True])
def test_lstm_matches_jax(batched):
    jl, tl, jp, tp = _pair("lstm", n_in=6, n_out=6, hidden_size=5,
                           activation="softmax")
    shape = (3, 4, 6) if batched else (4, 6)
    x = _x(shape)
    y = np.eye(6, dtype=np.float32)[np.random.default_rng(3).integers(
        0, 6, shape[:-1])]
    T, J = torch.from_numpy, jnp.asarray
    _close(tl.hidden_states(tp, T(x)), jl.hidden_states(jp, J(x)))
    _close(tl.activate(tp, T(x)), jl.activate(jp, J(x)))
    jv, jg = jax.value_and_grad(jl.loss)(jp, J(x), J(y))
    tv, tg = value_and_grad(tl.loss)(tp, T(x), T(y))
    _close(tv, jv)
    _close_tree(tg, jg)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("filt,pool", [((5, 5), (2, 2)), ((2, 3), (3, 2))])
def test_convolution_downsample_layer_matches_jax(padding, filt, pool):
    jl, tl, jp, tp = _pair("convolution_downsample", n_in=2, num_filters=3,
                           filter_size=filt, stride=pool, padding=padding,
                           activation="relu")
    x = _x((2, 12, 11, 2))
    T, J = torch.from_numpy, jnp.asarray
    _close(tl.pre_output(tp, T(x)), jl.pre_output(jp, J(x)))
    _close(tl.activate(tp, T(x)), jl.activate(jp, J(x)))

    def jsum(p, x):
        return jnp.sum(jl.activate(p, x) ** 2)

    def tsum(p, x):
        return torch.sum(tl.activate(p, x) ** 2)

    jv, jg = jax.value_and_grad(jsum)(jp, J(x))
    tv, tg = value_and_grad(tsum)(tp, T(x))
    _close(tv, jv)
    _close_tree(tg, jg)
    # a (N, H, W) input is one channel
    _, tl1, jp1, tp1 = _pair("convolution_downsample", n_in=1, num_filters=2)
    jl1 = JLy.create_layer(JCf.NeuralNetConfiguration(
        kind=JCf.LayerKind.CONVOLUTION_DOWNSAMPLE, n_in=1, num_filters=2))
    x3 = _x((2, 6, 6))
    _close(tl1.activate(tp1, T(x3)), jl1.activate(jp1, J(x3)))


def test_batchnorm_and_embedding_match_jax():
    jl, tl, jp, tp = _pair("batchnorm", n_out=4)
    x = _x((5, 3, 4))
    _close(tl.activate(tp, torch.from_numpy(x)), jl.activate(jp, jnp.asarray(x)))
    jl, tl, jp, tp = _pair("embedding", n_in=11, n_out=4)
    idx = np.array([[0, 3, 10], [5, 5, 1]], dtype=np.int32)
    _close(tl.activate(tp, torch.from_numpy(idx)),
           jl.activate(jp, jnp.asarray(idx)))
    _close(tl.pre_output(tp, torch.from_numpy(idx)),
           jl.pre_output(jp, jnp.asarray(idx)))


def test_every_layer_kind_is_registered():
    assert {k.value for k in TLy.REGISTRY} == {k.value for k in JLy.REGISTRY}
    for k, cls in TLy.REGISTRY.items():
        assert cls.__name__ == JLy.REGISTRY[JCf.LayerKind(k.value)].__name__
        assert cls.param_order == JLy.REGISTRY[
            JCf.LayerKind(k.value)].param_order
    with pytest.raises(ValueError, match="no layer registered"):
        TLy.create_layer(TCf.NeuralNetConfiguration(kind=TCf.LayerKind.CONV2D))


# ------------------------------------------------------------------ params plumbing

@pytest.mark.parametrize("kind,kw", [
    ("dense", {"n_in": 4, "n_out": 3}), ("rbm", {"n_in": 4, "n_out": 3}),
    ("lstm", {"n_in": 3, "n_out": 3, "hidden_size": 2}),
    ("convolution_downsample", {"n_in": 2, "num_filters": 3}),
    ("batchnorm", {"n_out": 3})])
def test_flatten_params_order_matches_jax(kind, kw):
    jl, tl, jp, tp = _pair(kind, **kw)
    flat = tl.flatten(tp)
    _close(flat, jl.flatten(jp), tol=0)
    assert tl.n_params(tp) == jl.n_params(jp) == flat.numel()
    back = tl.unflatten(flat * 2, tp)
    _close_tree(back, jax.tree_util.tree_map(lambda a: 2 * a, jp), tol=0)


def test_merge_params_matches_jax():
    _, _, jp1, tp1 = _pair("dense", seed=1, n_in=3, n_out=2)
    _, _, jp2, tp2 = _pair("dense", seed=2, n_in=3, n_out=2)
    _close_tree(TLy.merge_params([tp1, tp2]), JLy.merge_params([jp1, jp2]))


@pytest.mark.parametrize("scheme", [s.value for s in JCf.WeightInit])
@pytest.mark.parametrize("dist", ["uniform", "normal"])
def test_weight_init_schemes(scheme, dist):
    g = torch.Generator().manual_seed(0)
    shape = (40, 30)
    t = TW.init_weights(g, shape, TCf.WeightInit(scheme),
                        TCf.Distribution(dist), 0.1)
    j = np.asarray(JW.init_weights(jax.random.key(0), shape,
                                   JCf.WeightInit(scheme),
                                   JCf.Distribution(dist), 0.1))
    assert t.shape == j.shape and t.dtype == torch.float32
    # another stream, the same law: bounds and moments agree
    tn = t.numpy()
    assert abs(tn.min() - j.min()) <= 0.25 * max(abs(j.min()), 1e-3) + 0.05
    assert abs(tn.std() - j.std()) <= 0.15 * max(j.std(), 1e-3)
    if scheme == "zero":
        assert not tn.any()


# ------------------------------------------------------------------ configurations

_PRESETS = {
    "mlp": lambda z, **kw: z.mlp(4, 3, hidden=(8, 6), **kw),
    "dbn": lambda z, **kw: z.dbn(784, 10, **kw),
    "sda": lambda z, **kw: z.stacked_denoising_autoencoder(20, 5, **kw),
    "lenet": lambda z, **kw: z.lenet(10, **kw),
}


@pytest.mark.parametrize("preset", sorted(_PRESETS))
def test_zoo_conf_json_equals_the_reference(preset):
    t_json = _PRESETS[preset](TZ, device="cpu").conf.to_json()
    j_json = _PRESETS[preset](JZ).conf.to_json()
    assert t_json == j_json
    # each package loads the other's
    assert TCf.MultiLayerConfiguration.from_json(j_json).to_json() == j_json
    assert JCf.MultiLayerConfiguration.from_json(t_json).to_json() == t_json


def test_builder_overrides_and_layer_confs_round_trip():
    for mod in (TCf, JCf):
        base = mod.NeuralNetConfiguration(
            n_in=5, n_out=2, momentum_schedule={3: 0.9}, l2=1e-3,
            use_regularization=True, filter_size=(3, 3))
        conf = (mod.list_builder(base, 3).hidden_layer_sizes(7, 4)
                .override(2, kind="output", loss="mse",
                          optimization_algo="lbfgs", weight_init="zero",
                          visible_unit="gaussian", hidden_unit="rectified")
                .override_conf(mod.ConfOverride(0, {"dropout": 0.2}))
                .pretrain(False).backprop(True)
                .set(damping_factor=3.0, preprocessors={1: "none"}).build())
        if mod is TCf:
            t_json = conf.to_json()
        else:
            j_json = conf.to_json()
    assert t_json == j_json
    c = TCf.MultiLayerConfiguration.from_json(j_json)
    assert c.n_layers == 3 and c.conf(1).n_in == 7 and c.conf(2).seed == 125
    assert c.conf(0).momentum_at(5) == 0.9 and c.conf(0).momentum_at(2) == 0.5
    nc = c.conf(2)
    assert TCf.NeuralNetConfiguration.from_json(nc.to_json()) == nc
    assert nc.to_json() == JCf.NeuralNetConfiguration.from_json(
        nc.to_json()).to_json()
    assert dataclasses.fields(TCf.NeuralNetConfiguration) and \
        [f.name for f in dataclasses.fields(TCf.NeuralNetConfiguration)] == \
        [f.name for f in dataclasses.fields(JCf.NeuralNetConfiguration)]


def test_configuration_getters_and_substitution():
    c = TCf.Configuration({"a": "1", "b": "${a}0", "t": "yes", "f": 2.5,
                           "open": "${x"})
    assert c.get_int("b") == 10 and c.get_bool("t") and c.get_float("f") == 2.5
    assert c.get_str("open") == "${x" and c.get_int("missing", 7) == 7
    assert TCf.Configuration.from_json(c.to_json()) == c
    j = JCf.Configuration(dict(c))
    assert j.to_json() == c.to_json() and j.get_str("b") == c.get_str("b")
