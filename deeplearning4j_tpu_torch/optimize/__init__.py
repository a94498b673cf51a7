"""The optimization engine: gradient transforms, solvers (GD / CG /
L-BFGS / line search / Hessian-free) and the listener / termination /
early-stopping SPI (port of ``deeplearning4j_tpu/optimize``)."""

from . import api, solvers, transforms
from .api import (
    ComposableIterationListener,
    DefaultStepFunction,
    EpsTermination,
    GradientStepFunction,
    NegativeDefaultStepFunction,
    Norm2Termination,
    OutputLayerTrainingEvaluator,
    ScoreIterationListener,
    TimingListener,
    ZeroDirection,
)
from .solvers import (
    BackTrackLineSearch,
    BaseOptimizer,
    ConjugateGradient,
    GradientAscent,
    IterationGradientDescent,
    LBFGS,
    OptimizeResult,
    Solver,
    StochasticHessianFree,
)
from .transforms import GradientTransform, apply_updates, chain, from_conf

__all__ = [
    "api", "solvers", "transforms",
    "ComposableIterationListener", "DefaultStepFunction", "EpsTermination",
    "GradientStepFunction", "NegativeDefaultStepFunction", "Norm2Termination",
    "OutputLayerTrainingEvaluator", "ScoreIterationListener", "TimingListener",
    "ZeroDirection",
    "BackTrackLineSearch", "BaseOptimizer", "ConjugateGradient",
    "GradientAscent", "IterationGradientDescent", "LBFGS", "OptimizeResult",
    "Solver", "StochasticHessianFree",
    "GradientTransform", "apply_updates", "chain", "from_conf",
]
