"""Typed model configuration with JSON round-trip.

Port of ``deeplearning4j_tpu/nn/conf.py``, copied as it is (the module
imports no JAX; the port keeps its own copy so that it imports nothing
of the JAX package): the enums, ``NeuralNetConfiguration``,
``MultiLayerConfiguration``, the list builder, ``ConfOverride`` and
``Configuration``.  ``to_json`` gives the reference's strings exactly, so
each package loads the other's configurations.  Configs are frozen
dataclasses; activations, losses and weight inits are names resolved by
registries, and the RNG is a seed.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

from ..ops.losses import LossFunction


class OptimizationAlgorithm(str, enum.Enum):
    """Mirrors ``nn/api/OptimizationAlgorithm.java`` (enum of solver kinds)."""

    GRADIENT_DESCENT = "gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    HESSIAN_FREE = "hessian_free"
    LBFGS = "lbfgs"
    ITERATION_GRADIENT_DESCENT = "iteration_gradient_descent"


class WeightInit(str, enum.Enum):
    """Mirrors ``nn/weights/WeightInit.java:7-16`` scheme names."""

    VI = "vi"                     # Glorot-like: uniform * sqrt(6)/sqrt(fan_in+fan_out+1)
    ZERO = "zero"
    SIZE = "size"
    DISTRIBUTION = "distribution"
    NORMALIZED = "normalized"
    UNIFORM = "uniform"


class Distribution(str, enum.Enum):
    """Weight distributions (reference: ``distributions/Distributions.java``)."""

    UNIFORM = "uniform"
    NORMAL = "normal"


class RBMVisibleUnit(str, enum.Enum):
    """Mirrors ``models/featuredetectors/rbm/RBM.java:54-62`` VisibleUnit."""

    BINARY = "binary"
    GAUSSIAN = "gaussian"
    SOFTMAX = "softmax"
    LINEAR = "linear"


class RBMHiddenUnit(str, enum.Enum):
    """Mirrors ``RBM.java:64-70`` HiddenUnit."""

    RECTIFIED = "rectified"
    BINARY = "binary"
    GAUSSIAN = "gaussian"
    SOFTMAX = "softmax"


# Layer kinds known to the layer registry (nn/layers/factory/LayerFactories
# equivalent — see nn/layers.py REGISTRY).
class LayerKind(str, enum.Enum):
    DENSE = "dense"
    OUTPUT = "output"
    RBM = "rbm"
    AUTOENCODER = "autoencoder"
    RECURSIVE_AUTOENCODER = "recursive_autoencoder"
    LSTM = "lstm"
    CONVOLUTION_DOWNSAMPLE = "convolution_downsample"
    # Beyond-v0 additions for the north-star models:
    CONV2D = "conv2d"
    MAXPOOL2D = "maxpool2d"
    BATCHNORM = "batchnorm"
    EMBEDDING = "embedding"
    ATTENTION = "attention"


@dataclass(frozen=True)
class NeuralNetConfiguration:
    """Per-layer hyperparameters.

    Field-for-field capability match of the reference's
    ``NeuralNetConfiguration`` bean (~35 knobs, ``NeuralNetConfiguration.java:
    35-100``); fields that only made sense for mutable Java objects (live rng,
    live dist object) are replaced by ``seed``/``dist`` names.
    """

    # core optimization knobs
    lr: float = 1e-1
    momentum: float = 0.5
    momentum_schedule: dict[int, float] = field(default_factory=dict)  # iteration -> momentum
    l2: float = 0.0
    use_regularization: bool = False
    dropout: float = 0.0
    sparsity: float = 0.0
    apply_sparsity: bool = False
    corruption_level: float = 0.3        # denoising AE input corruption
    num_iterations: int = 1000           # optimizer iterations (reference default 1000)
    optimization_algo: OptimizationAlgorithm = OptimizationAlgorithm.CONJUGATE_GRADIENT
    lr_score_based_decay: float = 0.0
    minimize: bool = False               # reference maximizes score by default (GradientAscent)
    constrain_gradient_to_unit_norm: bool = False
    use_adagrad: bool = True
    reset_adagrad_iterations: int = -1

    # shapes
    n_in: int = 0
    n_out: int = 0
    batch_size: int = 0                  # 0 = whole batch

    # layer semantics
    kind: LayerKind = LayerKind.DENSE
    activation: str = "sigmoid"
    loss: LossFunction = LossFunction.RECONSTRUCTION_CROSSENTROPY
    weight_init: WeightInit = WeightInit.VI
    dist: Distribution = Distribution.NORMAL
    dist_std: float = 1e-2               # std / half-width for DISTRIBUTION init
    seed: int = 123

    # pretrain (RBM) knobs
    k: int = 1                           # CD-k Gibbs steps
    visible_unit: RBMVisibleUnit = RBMVisibleUnit.BINARY
    hidden_unit: RBMHiddenUnit = RBMHiddenUnit.BINARY

    # conv knobs (reference: filterSize/stride/featureMapSize)
    filter_size: tuple[int, int] = (2, 2)
    stride: tuple[int, int] = (2, 2)
    num_filters: int = 1
    padding: str = "VALID"

    # recurrent knobs
    hidden_size: int = 0

    # misc
    render_weights_every_n: int = 0
    extra: dict[str, Any] = field(default_factory=dict)  # forward-compat knobs

    # ------------------------------------------------------------------ serde
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, enum.Enum):
                d[k] = v.value
        d["momentum_schedule"] = {str(k): v for k, v in self.momentum_schedule.items()}
        d["filter_size"] = list(self.filter_size)
        d["stride"] = list(self.stride)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "NeuralNetConfiguration":
        kw = dict(d)
        kw["optimization_algo"] = OptimizationAlgorithm(kw.get("optimization_algo", "conjugate_gradient"))
        kw["kind"] = LayerKind(kw.get("kind", "dense"))
        kw["loss"] = LossFunction(kw.get("loss", "reconstruction_crossentropy"))
        kw["weight_init"] = WeightInit(kw.get("weight_init", "vi"))
        kw["dist"] = Distribution(kw.get("dist", "normal"))
        kw["visible_unit"] = RBMVisibleUnit(kw.get("visible_unit", "binary"))
        kw["hidden_unit"] = RBMHiddenUnit(kw.get("hidden_unit", "binary"))
        kw["momentum_schedule"] = {int(k): float(v) for k, v in kw.get("momentum_schedule", {}).items()}
        kw["filter_size"] = tuple(kw.get("filter_size", (2, 2)))
        kw["stride"] = tuple(kw.get("stride", (2, 2)))
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in kw.items() if k in known}
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "NeuralNetConfiguration":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "NeuralNetConfiguration":
        return dataclasses.replace(self, **kw)

    def momentum_at(self, iteration: int) -> float:
        """Momentum with schedule lookup (``BaseOptimizer.java:75-84``)."""
        m = self.momentum
        if self.momentum_schedule:
            applicable = [it for it in self.momentum_schedule if it <= iteration]
            if applicable:
                m = self.momentum_schedule[max(applicable)]
        return m


# Type alias used across the package: a layer config IS a NeuralNetConfiguration.
LayerConfig = NeuralNetConfiguration


@dataclass(frozen=True)
class ConfOverride:
    """Per-layer field overrides applied by ``MultiLayerConfiguration.Builder``.

    Mirrors ``NeuralNetConfiguration.ConfOverride`` (``:735-785``) — the
    reference mutates layer i's conf in a callback; here it is a dict of
    field replacements for layer ``layer_index``.
    """

    layer_index: int
    overrides: dict[str, Any] = field(default_factory=dict)

    def apply(self, conf: NeuralNetConfiguration) -> NeuralNetConfiguration:
        kw = dict(self.overrides)
        # Allow enum names as strings in overrides.
        if "kind" in kw:
            kw["kind"] = LayerKind(kw["kind"])
        if "loss" in kw:
            kw["loss"] = LossFunction(kw["loss"])
        if "optimization_algo" in kw:
            kw["optimization_algo"] = OptimizationAlgorithm(kw["optimization_algo"])
        if "weight_init" in kw:
            kw["weight_init"] = WeightInit(kw["weight_init"])
        if "visible_unit" in kw:
            kw["visible_unit"] = RBMVisibleUnit(kw["visible_unit"])
        if "hidden_unit" in kw:
            kw["hidden_unit"] = RBMHiddenUnit(kw["hidden_unit"])
        return conf.replace(**kw)


@dataclass(frozen=True)
class MultiLayerConfiguration:
    """Whole-network configuration.

    Mirrors ``nn/conf/MultiLayerConfiguration.java:13-120``: a list of
    per-layer confs + network-level knobs (hidden sizes, pretrain flag,
    dropconnect, Hessian-free damping) + JSON round-trip.
    """

    confs: tuple[NeuralNetConfiguration, ...] = ()
    hidden_layer_sizes: tuple[int, ...] = ()
    pretrain: bool = True
    backprop: bool = True
    use_dropconnect: bool = False
    use_gauss_newton_vector_product_back_prop: bool = False
    damping_factor: float = 100.0        # HF damping default (MultiLayerConfiguration.java:22)
    use_rbm_propagation: bool = False    # propagate via sampled vs mean activations in pretrain
    # per-layer OutputPreProcessor map (reference: ``MultiLayerConfiguration``
    # processors + ``nn/conf/preprocessor/ReshapePreProcessor``): name of a
    # registered post-processing applied to layer i's OUTPUT before layer i+1.
    preprocessors: dict[int, str] = field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "confs", tuple(self.confs))
        object.__setattr__(self, "hidden_layer_sizes", tuple(self.hidden_layer_sizes))
        object.__setattr__(self, "preprocessors",
                           {int(k): v for k, v in dict(self.preprocessors).items()})

    @property
    def n_layers(self) -> int:
        return len(self.confs)

    def conf(self, i: int) -> NeuralNetConfiguration:
        return self.confs[i]

    # ------------------------------------------------------------------ serde
    def to_dict(self) -> dict:
        return {
            "confs": [c.to_dict() for c in self.confs],
            "hidden_layer_sizes": list(self.hidden_layer_sizes),
            "pretrain": self.pretrain,
            "backprop": self.backprop,
            "use_dropconnect": self.use_dropconnect,
            "use_gauss_newton_vector_product_back_prop": self.use_gauss_newton_vector_product_back_prop,
            "damping_factor": self.damping_factor,
            "use_rbm_propagation": self.use_rbm_propagation,
            "preprocessors": {str(k): v for k, v in self.preprocessors.items()},
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MultiLayerConfiguration":
        kw = dict(d)
        kw["confs"] = tuple(NeuralNetConfiguration.from_dict(c) for c in kw.get("confs", []))
        kw["hidden_layer_sizes"] = tuple(kw.get("hidden_layer_sizes", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kw.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "MultiLayerConfiguration":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "MultiLayerConfiguration":
        return dataclasses.replace(self, **kw)


class ListBuilder:
    """Mirrors ``NeuralNetConfiguration.ListBuilder`` — expand one base conf
    into a per-layer list, sizing n_in/n_out from input size + hidden sizes,
    then apply ``ConfOverride``s."""

    def __init__(self, base: NeuralNetConfiguration, n_layers: int):
        self._base = base
        self._n_layers = n_layers
        self._overrides: list[ConfOverride] = []
        self._net_kw: dict[str, Any] = {}

    def override(self, layer_index: int, **overrides) -> "ListBuilder":
        self._overrides.append(ConfOverride(layer_index, overrides))
        return self

    def override_conf(self, ov: ConfOverride) -> "ListBuilder":
        self._overrides.append(ov)
        return self

    def hidden_layer_sizes(self, *sizes: int) -> "ListBuilder":
        self._net_kw["hidden_layer_sizes"] = tuple(sizes)
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._net_kw["pretrain"] = flag
        return self

    def backprop(self, flag: bool) -> "ListBuilder":
        self._net_kw["backprop"] = flag
        return self

    def set(self, **net_kw) -> "ListBuilder":
        self._net_kw.update(net_kw)
        return self

    def build(self) -> MultiLayerConfiguration:
        confs = [self._base for _ in range(self._n_layers)]
        hidden = self._net_kw.get("hidden_layer_sizes", ())
        if hidden:
            # Size the chain: layer0 (n_in -> hidden[0]) ... last (hidden[-1] -> n_out).
            n_in, n_out = self._base.n_in, self._base.n_out
            sizes_in = [n_in] + list(hidden)
            sizes_out = list(hidden) + [n_out]
            confs = [
                c.replace(n_in=sizes_in[i], n_out=sizes_out[i], seed=c.seed + i)
                for i, c in enumerate(confs)
            ]
        for ov in self._overrides:
            confs[ov.layer_index] = ov.apply(confs[ov.layer_index])
        return MultiLayerConfiguration(confs=tuple(confs), **self._net_kw)


def list_builder(base: NeuralNetConfiguration, n_layers: int) -> ListBuilder:
    return ListBuilder(base, n_layers)


class Configuration(dict):
    """Untyped string key/value runtime configuration.

    Capability match of the Hadoop-derived ``nn/conf/Configuration.java:19``
    used by the scaleout layer for cluster knobs — here a thin dict with
    typed getters and ``${var}`` substitution.
    """

    def get_str(self, key: str, default: str | None = None) -> str | None:
        v = self.get(key, default)
        return self._subst(v) if isinstance(v, str) else v

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        return int(self._subst(v)) if v is not None else default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key)
        return float(self._subst(v)) if v is not None else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        return str(self._subst(v)).strip().lower() in ("1", "true", "yes", "on")

    def _subst(self, v):
        if not isinstance(v, str):
            return v
        out, guard = v, 0
        while "${" in out and guard < 10:
            start = out.index("${")
            end = out.find("}", start)
            if end == -1:  # unclosed ${ — return verbatim rather than crash
                break
            var = out[start + 2:end]
            out = out[:start] + str(self.get(var, "")) + out[end + 1:]
            guard += 1
        return out

    def to_json(self) -> str:
        return json.dumps(self, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Configuration":
        return cls(json.loads(s))
