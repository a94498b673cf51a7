"""The port's ``MultiLayerNetwork`` and solvers against the JAX package's.

Both networks start from the reference's parameters (numpy across,
``models.convert``) and train on the same numpy data in float32.  A
20-iteration fit and the CG / L-BFGS / Hessian-free runs are held to
1e-4 relative on every parameter leaf and on the score; the line-search
solvers also to the same accepted step at every iteration.  The problems
were chosen so that no branch (an Armijo test, a CG restart, a damping
update, a termination) sits within rounding of its threshold: each test
asserts the branches it can see agree.  The DBN's CD-1 pretraining runs
on the reference's own draws (its key splits replayed with ``jax.random``
and fed to ``RBM._cd_k``).  Hessian-free's CG solve runs under
``NoHostSync``: no read of the device inside it."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as JZ
from deeplearning4j_tpu.nn import conf as JCf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize import solvers as JS
from deeplearning4j_tpu_torch.datasets import DataSet, IrisDataSetIterator
from deeplearning4j_tpu_torch.models import zoo as TZ
from deeplearning4j_tpu_torch.models.convert import (params_from_numpy,
                                                     params_to_numpy)
from deeplearning4j_tpu_torch.nn import layers as TLy
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.optimize import api as TA
from deeplearning4j_tpu_torch.optimize import solvers as TS
from deeplearning4j_tpu_torch.utils.autodiff import value_and_grad
from torch_sync_guard import NoHostSync

TOL_FIT = 1e-4


def _rel_err(t_params, j_params) -> float:
    """max over leaves of max |t - j| / max |j|."""
    errs = []
    for tp, jp in zip(t_params, j_params):
        for k in jp:
            a = tp[k].detach().numpy()
            b = np.asarray(jp[k])
            errs.append(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))
    return max(errs)


def _twins(jnet_fn, tnet_fn, seed=0):
    """A reference network and a port network with the same parameters."""
    j = jnet_fn()
    j.init(jax.random.key(seed))
    t = tnet_fn()
    t.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, j.params), device="cpu")
    return j, t


def _iris():
    ds = IrisDataSetIterator(batch=150).next()
    return ds.normalize_zero_mean_unit_variance().shuffle(seed=42)


def _jds(ds):
    return JDataSet(ds.features, ds.labels)


def _digits_like(n=64, d=16, c=4, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(n, d)) > 0.5).astype(np.float32)
    teacher = rng.standard_normal((d, c))
    y = np.eye(c, dtype=np.float32)[np.argmax(x @ teacher, axis=1)]
    return DataSet(x, y)


# ------------------------------------------------------------------ first order

def test_mlp_fit_on_iris_matches_jax():
    ds = _iris()
    j, t = _twins(lambda: JZ.mlp(4, 3, hidden=(16,), num_iterations=20),
                  lambda: TZ.mlp(4, 3, hidden=(16,), num_iterations=20,
                                 device="cpu"))
    j.fit(_jds(ds))
    t.fit(ds)
    assert _rel_err(t.params, j.params) < TOL_FIT
    assert abs(t.score() - j.score()) <= TOL_FIT * abs(j.score())
    # the same classifier, so the same evaluation text
    assert t.evaluate(ds).stats() == j.evaluate(_jds(ds)).stats()
    np.testing.assert_array_equal(t.predict(ds.features),
                                  j.predict(ds.features))


def test_first_order_fit_with_minibatches_listeners_and_score_every():
    ds = _iris()
    j, t = _twins(lambda: JZ.mlp(4, 3, hidden=(8,), num_iterations=3),
                  lambda: TZ.mlp(4, 3, hidden=(8,), num_iterations=3,
                                 device="cpu"))
    t.score_every = 4
    listener = TA.ScoreIterationListener(print_every=2)
    t.listeners.append(listener)
    batches = ds.batch_by(50)
    j.fit([_jds(b) for b in batches])
    t.fit(batches)
    assert len(listener.scores) == 9
    assert _rel_err(t.params, j.params) < TOL_FIT
    assert abs(t.score() - j.score()) <= TOL_FIT * abs(j.score())
    # fit_arrays: int labels become one-hot
    j2, t2 = _twins(lambda: JZ.mlp(4, 3, num_iterations=2),
                    lambda: TZ.mlp(4, 3, num_iterations=2, device="cpu"))
    idx = ds.labels.argmax(1)
    j2.fit_arrays(ds.features, idx)
    t2.fit_arrays(ds.features, idx)
    assert _rel_err(t2.params, j2.params) < TOL_FIT


def test_lenet_forward_loss_grads_and_step_match_jax():
    """LeNet's output, loss and gradients at 1e-5; its fit after one
    AdaGrad step at 1e-4.  (AdaGrad's first step divides a gradient by
    sqrt(g^2 + 1e-6): where |g| is near 0 it multiplies the packages'
    ~1e-8 gradient difference by up to lr/1e-3 = 50, and 39% of the dense
    layer's gradients lie under 1e-3 here; three steps measured 2.1e-4.)"""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(6, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)]
    j, t = _twins(lambda: JZ.lenet(10, num_iterations=1),
                  lambda: TZ.lenet(10, num_iterations=1, device="cpu"))
    np.testing.assert_allclose(t.output(x).numpy(), np.asarray(j.output(x)),
                               rtol=1e-5, atol=1e-6)
    jv, jg = jax.value_and_grad(j.supervised_loss)(j.params, jnp.asarray(x),
                                                   jnp.asarray(y))
    tv, tg = value_and_grad(t.supervised_loss)(t.params, torch.from_numpy(x),
                                               torch.from_numpy(y))
    assert abs(float(tv) - float(jv)) <= 1e-5 * abs(float(jv))
    assert _rel_err(tg, jg) < 1e-5
    j.fit(JDataSet(x, y))
    t.fit(DataSet(x, y))
    assert _rel_err(t.params, j.params) < TOL_FIT


# ------------------------------------------------------------------ DBN: pretrain on the reference's draws

def _replay_reference_draws(monkeypatch, seed):
    """Make the port's RBMs draw what the reference's pretrain loop draws:
    one key split per iteration from ``key(seed)``, then CD-k's splits."""
    from test_torch_nn import _jax_cd_draws
    state = {"key": jax.random.key(seed)}

    def draws(self, gen, x):
        state["key"], sub = jax.random.split(state["key"])
        c = self.conf
        return _jax_cd_draws(sub, c.visible_unit.value, c.hidden_unit.value,
                             x.shape[0], c.n_in, c.n_out, c.k)

    monkeypatch.setattr(TLy.RBM, "_cd_draws", draws)


def test_dbn_fit_matches_jax_on_its_draws(monkeypatch):
    ds = _digits_like()
    j, t = _twins(lambda: JZ.dbn(16, 4, hidden=(12, 8), pretrain_iterations=4,
                                 finetune_iterations=6),
                  lambda: TZ.dbn(16, 4, hidden=(12, 8), pretrain_iterations=4,
                                 finetune_iterations=6, device="cpu"))
    _replay_reference_draws(monkeypatch, j.conf.confs[0].seed + 7)
    j.fit(_jds(ds))
    t.fit(ds)
    assert _rel_err(t.params, j.params) < TOL_FIT
    assert abs(t.score() - j.score()) <= TOL_FIT * abs(j.score())


def test_stacked_denoising_autoencoder_pretrains_on_the_card_api():
    ds = _digits_like(n=32)
    net = TZ.stacked_denoising_autoencoder(16, 4, hidden=(10,),
                                           pretrain_iterations=3,
                                           finetune_iterations=3,
                                           device="cpu")
    net.init(0)
    before = [p["W"].clone() for p in net.params]
    net.fit(ds)
    assert np.isfinite(net.score())
    assert all(not torch.equal(b, p["W"]) for b, p in zip(before, net.params))


# ------------------------------------------------------------------ solvers

def _solver_twins(algo, iterations, hidden=(10,), seed=0):
    def build(mod):
        base = mod.NeuralNetConfiguration(
            n_in=4, n_out=3, lr=0.1, num_iterations=iterations,
            activation="tanh", seed=seed, use_adagrad=False, momentum=0.0,
            optimization_algo=mod.OptimizationAlgorithm(algo))
        return (mod.list_builder(base, len(hidden) + 1)
                .hidden_layer_sizes(*hidden)
                .override(len(hidden), kind="output", activation="softmax",
                          loss="mcxent")
                .pretrain(False).build())

    conf = build(JCf)
    return _twins(lambda: JNet(conf),
                  lambda: TNet(MultiLayerConfiguration.from_json(
                      conf.to_json()), device="cpu"))


def _record_steps(monkeypatch, cls, steps):
    orig = cls.optimize

    def optimize(self, *a, **kw):
        s = orig(self, *a, **kw)
        steps.append(s)
        return s

    monkeypatch.setattr(cls, "optimize", optimize)


@pytest.mark.parametrize("algo", ["gradient_descent", "conjugate_gradient",
                                  "lbfgs"])
def test_line_search_solvers_match_jax(algo, monkeypatch):
    """CG and L-BFGS through ``finetune``; steepest descent (which
    ``finetune`` runs as a first-order step) through the ``Solver``
    facade on the network's objective."""
    ds = _iris()
    j, t = _solver_twins(algo, 12)
    jsteps, tsteps = [], []
    _record_steps(monkeypatch, JS.BackTrackLineSearch, jsteps)
    _record_steps(monkeypatch, TS.BackTrackLineSearch, tsteps)
    if algo == "gradient_descent":
        x, y = ds.features, ds.labels
        jr = JS.Solver(j.layers[-1].conf, lambda p, k, x, y: jax.value_and_grad(
            j.supervised_loss)(p, x, y), batches=[(x, y)]).optimize(
                j.params, jax.random.key(0))
        tr = TS.Solver(t.layers[-1].conf, lambda p, g, x, y: value_and_grad(
            t.supervised_loss)(p, x, y), batches=[(
                torch.from_numpy(x), torch.from_numpy(y))]).optimize(t.params)
        assert tr.iterations == jr.iterations and tr.converged == jr.converged
        j.params, j._score, t.params, t._score = (jr.params, jr.score,
                                                  tr.params, tr.score)
    else:
        j.fit(_jds(ds))
        t.fit(ds)
    assert len(tsteps) == len(jsteps) > 1
    # the same accepted step every iteration (a step is 0.5^k of the first)
    np.testing.assert_allclose(tsteps, jsteps, rtol=1e-4)
    assert _rel_err(t.params, j.params) < TOL_FIT
    assert abs(t.score() - j.score()) <= TOL_FIT * abs(j.score())


def test_hessian_free_gauss_newton_matches_jax_without_host_syncs(monkeypatch):
    ds = _iris()
    j, t = _solver_twins("hessian_free", 4)
    solves = []
    orig = TS.StochasticHessianFree._cg_solve

    def guarded(self, *a, **kw):
        with NoHostSync() as guard:
            x = orig(self, *a, **kw)
        solves.append(guard.seen)
        return x

    monkeypatch.setattr(TS.StochasticHessianFree, "_cg_solve", guarded)
    jdamp, tdamp = [], []
    for mod, rec in ((JS, jdamp), (TS, tdamp)):
        orig_q = mod.StochasticHessianFree._model_quantities

        def q(self, *a, _orig=orig_q, _rec=rec, **kw):
            _rec.append(self.damping)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(mod.StochasticHessianFree, "_model_quantities", q)
    j.fit(_jds(ds))
    t.fit(ds)
    assert len(solves) == 4 and min(solves) > 100
    np.testing.assert_allclose(tdamp, jdamp, rtol=1e-6)   # same branches
    assert _rel_err(t.params, j.params) < TOL_FIT
    assert abs(t.score() - j.score()) <= TOL_FIT * abs(j.score())


def test_hessian_free_on_lenet_runs_forward_mode_through_the_pool():
    """jvp covers the conv, the max pool, the activations and the clamp
    of the loss: the Gauss-Newton product of LeNet matches the JAX one."""
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(3, 12, 12, 1)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 3)]
    j, t = _twins(lambda: JZ.lenet(4, input_side=12, num_filters=2),
                  lambda: TZ.lenet(4, input_side=12, num_filters=2,
                                   device="cpu"))
    vec = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        j.params)
    out_conf = j.layers[-1].conf

    def jpredict(p, k, x, y):
        h = x
        for i, (layer, q) in enumerate(zip(j.layers[:-1], p[:-1])):
            h = j._preproc(i, layer.activate(q, h))
        return j.layers[-1].pre_output(p[-1], h)

    def tpredict(p, k, x, y):
        h = x
        for i, (layer, q) in enumerate(zip(t.layers[:-1], p[:-1])):
            h = t._preproc(i, layer.activate(q, h))
        return t.layers[-1].pre_output(p[-1], h)

    from deeplearning4j_tpu.ops import activations as JA, losses as JLo
    from deeplearning4j_tpu_torch.ops import activations as TAc, losses as TLo

    jopt = JS.StochasticHessianFree(out_conf, lambda *a: None, gauss_newton=(
        jpredict, lambda z, x, y: JLo.score("mcxent", y, JA.apply("softmax",
                                                                   z))))
    topt = TS.StochasticHessianFree(
        MultiLayerConfiguration.from_json(j.conf.to_json()).confs[-1], None,
        gauss_newton=(tpredict, lambda z, x, y: TLo.score(
            "mcxent", y, TAc.apply("softmax", z))))
    jg = jopt._cvp(j.params, vec, None, (jnp.asarray(x), jnp.asarray(y)))
    tg = topt._cvp(t.params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, vec), device="cpu"), None,
        (torch.from_numpy(x), torch.from_numpy(y)))
    assert _rel_err(tg, jg) < 1e-4


def test_solver_facade_and_terminations():
    obj_calls = []

    def objective(p, gen):
        obj_calls.append(1)
        loss = ((p["w"] - 3.0) ** 2).sum()
        return loss, {"w": 2 * (p["w"] - 3.0)}

    conf = JCf.NeuralNetConfiguration(num_iterations=50, lr=0.1,
                                      use_adagrad=False, momentum=0.0)
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    tconf = NeuralNetConfiguration.from_json(conf.to_json())
    for algo in ("iteration_gradient_descent", "conjugate_gradient", "lbfgs",
                 "gradient_descent", "hessian_free"):
        c = tconf.replace(optimization_algo=algo)
        res = TS.Solver(c, objective).optimize({"w": torch.zeros(3)})
        assert res.score < 1e-3 or res.converged, (algo, res.score)
        assert isinstance(res, TS.OptimizeResult)
    assert TA.EpsTermination().terminate(1.0, 1.0 + 1e-6)
    assert TA.Norm2Termination(1e-3).terminate(0, 0, ({"w": torch.zeros(2)},))
    assert not TA.ZeroDirection().terminate(0, 0, ({"w": torch.ones(2)},))
    p = {"w": torch.ones(2)}
    d = {"w": torch.full((2,), 2.0)}
    assert torch.equal(TA.DefaultStepFunction().step(p, d, 0.5)["w"],
                       torch.full((2,), 2.0))
    assert torch.equal(TA.NegativeDefaultStepFunction().step(p, d, 0.5)["w"],
                       torch.zeros(2))


# ------------------------------------------------------------------ plumbing, save files

def test_params_plumbing_matches_jax():
    j, t = _twins(lambda: JZ.mlp(4, 3, hidden=(5, 4)),
                  lambda: TZ.mlp(4, 3, hidden=(5, 4), device="cpu"))
    np.testing.assert_array_equal(t.params_flat().numpy(),
                                  np.asarray(j.params_flat()))
    assert t.num_params() == j.num_params()
    flat = np.arange(t.num_params(), dtype=np.float32) / 100
    t.set_params_flat(flat)
    j.set_params_flat(flat)
    assert _rel_err(t.params, j.params) == 0
    x = _iris().features[:7]
    for a, b in zip(t.feed_forward(x), j.feed_forward(x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(t.reconstruct(x, 1).numpy(),
                               np.asarray(j.reconstruct(x, 1)), rtol=1e-5)
    np.testing.assert_allclose(t.label_probabilities(x).numpy(),
                               np.asarray(j.label_probabilities(x)),
                               rtol=1e-5)
    ds = _iris()
    assert abs(t.score(ds) - j.score(_jds(ds))) < 1e-5 * abs(j.score())
    other_j, other_t = _twins(lambda: JZ.mlp(4, 3, hidden=(5, 4)),
                              lambda: TZ.mlp(4, 3, hidden=(5, 4),
                                             device="cpu"), seed=3)
    j.merge(other_j)
    t.merge(other_t)
    assert _rel_err(t.params, j.params) < 1e-6
    c = t.clone()
    assert c.params[0]["W"] is not t.params[0]["W"]
    assert torch.equal(c.params[0]["W"], t.params[0]["W"])


def test_save_files_load_in_both_directions(tmp_path):
    ds = _iris()
    j, t = _twins(lambda: JZ.mlp(4, 3, num_iterations=3),
                  lambda: TZ.mlp(4, 3, num_iterations=3, device="cpu"))
    j.fit(_jds(ds))
    t.fit(ds)
    j.save(tmp_path / "ref.pkl")
    t.save(tmp_path / "port.pkl")
    with open(tmp_path / "port.pkl", "rb") as f:
        payload = pickle.load(f)
    assert isinstance(payload["params"][0]["W"], np.ndarray)
    t_from_ref = TNet.load(tmp_path / "ref.pkl", device="cpu")
    j_from_port = JNet.load(tmp_path / "port.pkl")
    assert t_from_ref.conf.to_json() == j.conf.to_json()
    assert _rel_err(t_from_ref.params, j.params) == 0
    assert _rel_err(t.params, j_from_port.params) == 0
    assert t_from_ref.evaluate(ds).stats() == j.evaluate(_jds(ds)).stats()
    assert j_from_port.evaluate(_jds(ds)).stats() == t.evaluate(ds).stats()
    # an unfit network saves no params; both load that too
    TZ.mlp(4, 3, device="cpu").save(tmp_path / "empty.pkl")
    assert JNet.load(tmp_path / "empty.pkl").params is None
    assert params_to_numpy(t.params)[0]["W"].dtype == np.float32
