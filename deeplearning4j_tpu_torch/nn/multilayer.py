"""MultiLayerNetwork — the training container.

Port of ``deeplearning4j_tpu/nn/multilayer.py``: build a layer stack from
a ``MultiLayerConfiguration``; greedy layerwise ``pretrain``; supervised
``finetune`` (first order, or through the CG / L-BFGS / Hessian-free
solvers); ``feed_forward`` / ``output`` / ``predict`` / ``score`` /
``evaluate``; the flat parameter vector; ``merge``; ``save`` / ``load``.

Parameters are a tuple of per-layer dicts of tensors on the network's
device (``device=``, ``cuda`` by default), updated functionally: a step
returns new tensors.  Gradients come from ``torch.func`` over the pure
``supervised_loss`` (``utils.autodiff``), as the reference's from
``jax.value_and_grad``.  The loss is read on the host only every
``score_every`` iterations and on the last, as in the reference.  Save
files hold the configuration's JSON and numpy arrays, the reference's
envelope, so each package loads the other's files.
"""

from __future__ import annotations

import logging
import pickle
import time
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..datasets.dataset import DataSet, to_outcome_matrix
from ..device import resolve_device
from ..evaluation import Evaluation
from ..observability import METRICS, enabled as _obs_enabled, trace
from ..optimize import transforms as tfm
from ..utils.autodiff import value_and_grad
from ..utils.tree_math import tree_map
from .conf import MultiLayerConfiguration, OptimizationAlgorithm
from .layers import BasePretrainLayer, Layer, create_layer, merge_params

log = logging.getLogger(__name__)

Params = tuple[dict[str, torch.Tensor], ...]

# OutputPreProcessor registry: named transforms applied to a layer's
# OUTPUT before the next layer.
PREPROCESSORS: dict[str, Callable] = {
    "flatten": lambda h: h.reshape(h.shape[0], -1),
    "none": lambda h: h,
}


class MultiLayerNetwork:
    """Layer stack + training orchestration."""

    def __init__(self, conf: MultiLayerConfiguration, *,
                 score_every: int = 1, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.layers: list[Layer] = [create_layer(c) for c in conf.confs]
        self.params: Params | None = None
        self._tstates: list[Any] | None = None
        self.listeners: list = []
        self._score = float("nan")
        # How often pretrain/finetune read the loss into the host
        # ``_score`` float: 1 (default) every iteration, as the reference;
        # more keeps the loop free of host syncs in between.  The last
        # iteration always reads, so ``score()`` stays correct.
        self.score_every = max(1, int(score_every))

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------------ init
    def init(self, gen=None) -> Params:
        """Build all param tables, drawn from ``gen`` (a generator or an
        int seed; by default a CPU generator seeded with the first layer's
        seed, so a CPU and a GPU network start from the same values) and
        placed on the network's device."""
        if gen is None:
            gen = self.conf.confs[0].seed
        if isinstance(gen, int):
            gen = torch.Generator().manual_seed(gen)
        self.params = tuple(
            {k: v.to(self.device) for k, v in layer.init(gen).items()}
            for layer in self.layers)
        self._tstates = None
        return self.params

    def _ensure_init(self):
        if self.params is None:
            self.init()

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------ forward
    def _preproc(self, i: int, h):
        """Apply layer i's OutputPreProcessor."""
        name = self.conf.preprocessors.get(i)
        return PREPROCESSORS[name](h) if name else h

    def feed_forward_fn(self, params: Params, x, rng=None,
                        train: bool = False):
        """Pure forward returning all activations."""
        acts = [x]
        h = x
        for i, (layer, p) in enumerate(zip(self.layers, params)):
            h = self._preproc(i, layer.activate(p, h, rng=rng, train=train))
            acts.append(h)
        return acts

    def _forward(self, params: Params, x):
        h = x
        for i, (layer, p) in enumerate(zip(self.layers, params)):
            h = self._preproc(i, layer.activate(p, h))
        return h

    def feed_forward(self, x) -> list:
        self._ensure_init()
        with torch.no_grad():
            return self.feed_forward_fn(self.params, self._tensor(x))

    def output(self, x) -> torch.Tensor:
        """Probabilities/activations of the final layer."""
        self._ensure_init()
        with torch.no_grad():
            return self._forward(self.params, self._tensor(x))

    def predict(self, x) -> np.ndarray:
        """Argmax class per row."""
        return torch.argmax(self.output(x), dim=-1).cpu().numpy()

    def label_probabilities(self, x) -> torch.Tensor:
        return self.output(x)

    def reconstruct(self, x, layer_idx: int) -> torch.Tensor:
        """Activations at layer ``layer_idx``."""
        acts = self.feed_forward(x)
        return acts[layer_idx]

    # ------------------------------------------------------------------ loss
    def supervised_loss(self, params: Params, x, labels, rng=None,
                        train: bool = False):
        out_layer = self.layers[-1]
        h = x
        for i, (layer, p) in enumerate(zip(self.layers[:-1], params[:-1])):
            h = self._preproc(i, layer.activate(p, h, rng=rng, train=train))
        if hasattr(out_layer, "loss"):  # OutputLayer, LSTM, or any loss-bearing tail
            return out_layer.loss(params[-1], h, labels)
        raise TypeError(f"final layer {type(out_layer).__name__} has no loss")

    def score(self, data: DataSet | None = None) -> float:
        """The supervised loss on the given batch (or the last one's)."""
        if data is not None:
            self._ensure_init()
            with torch.no_grad():
                self._score = float(self.supervised_loss(
                    self.params, self._tensor(data.features),
                    self._tensor(data.labels)))
        return self._score

    # ------------------------------------------------------------------ pretrain
    def pretrain(self, data_or_iter, gen=None) -> None:
        """Greedy layerwise pretraining: feed inputs through layers
        [0..i-1], then run layer i's unsupervised objective, its
        AdaGrad/momentum state on the device."""
        self._ensure_init()
        gen = gen if gen is not None else self._gen(
            self.conf.confs[0].seed + 7)
        batches = self._as_batches(data_or_iter)
        for i, layer in enumerate(self.layers):
            if not isinstance(layer, BasePretrainLayer):
                continue
            conf = layer.conf
            with trace.span("multilayer.pretrain_layer", layer=i,
                            kind=conf.kind.value):
                transform = tfm.from_conf(conf)
                lparams = self.params[i]
                tstate = transform.init(lparams)
                loss = None
                for b, batch in enumerate(batches):
                    x = self._tensor(batch.features)
                    # inputs to layer i are fixed while layer i trains
                    inp = self._forward_to(i, x)
                    for it in range(max(1, conf.num_iterations)):
                        loss, grads = layer.pretrain_value_and_grad(
                            lparams, inp, gen)
                        updates, tstate = transform.update(grads, tstate,
                                                           lparams, it)
                        lparams = tfm.apply_updates(lparams, updates)
                    # the score is a device->host read: off the hot loop
                    # unless asked for every batch
                    if (b + 1) % self.score_every == 0:
                        self._score = float(loss)
                if loss is not None:
                    self._score = float(loss)
                new_params = list(self.params)
                new_params[i] = lparams
                self.params = tuple(new_params)
            METRICS.increment("multilayer.pretrain_layers")
            log.info("pretrained layer %d (%s) score %.5f", i, conf.kind.value,
                     self._score)

    def _forward_to(self, i: int, x):
        """Inputs to layer i = activations of layers [0..i-1]."""
        with torch.no_grad():
            h = x
            for j, (layer, p) in enumerate(zip(self.layers[:i],
                                               self.params[:i])):
                h = self._preproc(j, layer.activate(p, h))
            return h

    # ------------------------------------------------------------------ finetune
    def finetune(self, data_or_iter, gen=None) -> None:
        """Supervised training of the whole stack: first-order algorithms
        run the minibatch step; CG / L-BFGS / HF go to the solvers on the
        batch objective."""
        self._ensure_init()
        out_conf = self.layers[-1].conf
        gen = gen if gen is not None else self._gen(out_conf.seed + 13)
        batches = self._as_batches(data_or_iter)
        algo = out_conf.optimization_algo
        if algo in (OptimizationAlgorithm.GRADIENT_DESCENT,
                    OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT):
            self._finetune_first_order(batches, gen)
        else:
            self._finetune_solver(batches, gen, algo)

    def _train_step(self, transform):
        grad_fn = value_and_grad(self.supervised_loss)

        def step(params, tstate, x, y, gen, iteration):
            loss, grads = grad_fn(params, x, y, gen, True)
            updates, tstate = transform.update(grads, tstate, params,
                                               iteration)
            return tfm.apply_updates(params, updates), tstate, loss

        return step

    def _finetune_first_order(self, batches: Sequence[DataSet], gen) -> None:
        out_conf = self.layers[-1].conf
        transform = tfm.from_conf(out_conf)
        step = self._train_step(transform)
        tstate = (self._tstates if self._tstates is not None
                  else transform.init(self.params))
        it = 0
        n_total = len(batches) * max(1, out_conf.num_iterations)
        for batch in batches:
            x, y = self._tensor(batch.features), self._tensor(batch.labels)
            for _ in range(max(1, out_conf.num_iterations)):
                obs = _obs_enabled()
                t0 = time.perf_counter() if obs else 0.0
                # rebind at once: listeners (which may call output()) must
                # see the new parameters
                self.params, tstate, loss = step(self.params, tstate, x, y,
                                                 gen, it)
                self._tstates = tstate
                it += 1
                # float(loss) waits for the device: only every
                # score_every steps, and on the last
                if it % self.score_every == 0 or it == n_total:
                    self._score = float(loss)
                    if obs:
                        METRICS.gauge("multilayer.loss", self._score)
                if obs:
                    METRICS.observe_time("multilayer.fit_iteration",
                                         time.perf_counter() - t0)
                    METRICS.increment("multilayer.iterations")
                for l in self.listeners:
                    l.iteration_done(self, it)

    def _finetune_solver(self, batches: Sequence[DataSet], gen, algo) -> None:
        from ..optimize.solvers import Solver  # deferred: import cycle
        # mini-batch mode: the solver cycles the batches across outer
        # iterations
        data = [(self._tensor(b.features), self._tensor(b.labels))
                for b in batches]
        grad_fn = value_and_grad(self.supervised_loss)

        def objective(params, k, x, y):
            return grad_fn(params, x, y)

        out_conf = self.layers[-1].conf
        extra = {}
        if algo == OptimizationAlgorithm.HESSIAN_FREE:
            # Gauss-Newton split: predict = the network up to the final
            # pre-activation z; loss_out = the convex loss of z
            from ..ops import activations as _act
            from ..ops import losses as _losses

            def predict(params, k, x, y):
                h = x
                for i, (layer, p) in enumerate(zip(self.layers[:-1],
                                                   params[:-1])):
                    h = self._preproc(i, layer.activate(p, h))
                return self.layers[-1].pre_output(params[-1], h)

            def loss_out(z, x, y):
                return _losses.score(out_conf.loss, y,
                                     _act.apply(out_conf.activation, z))

            extra = {"damping": self.conf.damping_factor,
                     "gauss_newton": (predict, loss_out)}
        solver = Solver(out_conf, objective, listeners=self.listeners,
                        batches=data, **extra)
        result = solver.optimize(self.params, gen)
        self.params = result.params
        self._score = result.score

    # ------------------------------------------------------------------ fit
    def fit(self, data_or_iter, gen=None) -> "MultiLayerNetwork":
        """``fit = pretrain + finetune`` (one generator for both)."""
        self._ensure_init()
        with trace.span("multilayer.fit", n_layers=len(self.layers)):
            if self.conf.pretrain:
                with trace.span("multilayer.pretrain"):
                    self.pretrain(data_or_iter, gen)
            if self.conf.backprop:
                with trace.span("multilayer.finetune"):
                    self.finetune(data_or_iter, gen)
        return self

    def fit_arrays(self, features, labels_or_idx,
                   gen=None) -> "MultiLayerNetwork":
        """Classifier.fit(x, labels) — int labels become one-hot."""
        labels = np.asarray(labels_or_idx)
        if labels.ndim == 1:
            labels = to_outcome_matrix(labels, self.layers[-1].conf.n_out)
        return self.fit(DataSet(np.asarray(features), labels), gen)

    def _as_batches(self, data_or_iter) -> list[DataSet]:
        if isinstance(data_or_iter, DataSet):
            bs = self.layers[-1].conf.batch_size
            return data_or_iter.batch_by(bs) if bs > 0 else [data_or_iter]
        return list(data_or_iter)

    # ------------------------------------------------------------------ eval
    def evaluate(self, data_or_iter) -> Evaluation:
        ev = Evaluation()
        with trace.span("multilayer.evaluate"):
            for batch in self._as_batches(data_or_iter):
                ev.eval(batch.labels, self.output(batch.features))
                METRICS.increment("evaluate.batches")
        return ev

    # ------------------------------------------------------------------ params plumbing
    def params_flat(self) -> torch.Tensor:
        """Flatten all params in layer/key order."""
        self._ensure_init()
        return torch.cat([layer.flatten(p)
                          for layer, p in zip(self.layers, self.params)])

    def set_params_flat(self, flat) -> None:
        self._ensure_init()
        flat = self._tensor(flat)
        out, off = [], 0
        for layer, p in zip(self.layers, self.params):
            n = layer.n_params(p)
            out.append(layer.unflatten(flat[off:off + n], p))
            off += n
        self.params = tuple(out)

    def num_params(self) -> int:
        self._ensure_init()
        return sum(l.n_params(p) for l, p in zip(self.layers, self.params))

    def merge(self, *others: "MultiLayerNetwork") -> None:
        """Parameter averaging with peers (data-parallel aggregation)."""
        self._ensure_init()
        all_params = [self.params] + [o.params for o in others]
        self.params = merge_params(all_params)

    def clone(self) -> "MultiLayerNetwork":
        net = MultiLayerNetwork(self.conf, score_every=self.score_every,
                                device=self.device)
        if self.params is not None:
            net.params = tree_map(lambda x: x.clone(), self.params)
        return net

    # ------------------------------------------------------------------ persistence
    def save(self, path: str | Path) -> None:
        """Config JSON + numpy params in one pickle envelope (the
        reference's format)."""
        payload = {
            "conf_json": self.conf.to_json(),
            "params": None if self.params is None else
            [{k: v.detach().cpu().numpy() for k, v in p.items()}
             for p in self.params],
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    @classmethod
    def load(cls, path: str | Path, *, device=None) -> "MultiLayerNetwork":
        with open(path, "rb") as f:
            payload = pickle.load(f)
        net = cls(MultiLayerConfiguration.from_json(payload["conf_json"]),
                  device=device)
        if payload["params"] is not None:
            net.params = tuple({k: net._tensor(np.asarray(v))
                                for k, v in p.items()}
                               for p in payload["params"])
        return net
