"""Optimization SPI: listeners, step functions, termination conditions,
training evaluators.

Port of ``deeplearning4j_tpu/optimize/api.py`` (the listeners, step
functions, terminations and the early-stopping evaluator), over the
port's parameter trees (``utils.tree_math``).  A termination that reads a
gradient norm reads it on the host, as the reference does.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Protocol, Sequence

log = logging.getLogger(__name__)


# --------------------------------------------------------------------------- listeners

class IterationListener(Protocol):
    """``optimize/api/IterationListener.java`` — invoked each optimizer
    iteration (``BaseOptimizer.java:176-177``)."""

    def iteration_done(self, model: Any, iteration: int) -> None: ...


class ScoreIterationListener:
    """Log score every N iterations (reference logs each iteration,
    ``BaseOptimizer.java:201``)."""

    def __init__(self, print_every: int = 10):
        self.print_every = print_every
        self.scores: list[float] = []

    def iteration_done(self, model, iteration: int) -> None:
        score = float(model.score()) if hasattr(model, "score") else float("nan")
        self.scores.append(score)
        if iteration % self.print_every == 0:
            log.info("iteration %d score %.6f", iteration, score)


class ComposableIterationListener:
    """``optimize/listeners/ComposableIterationListener.java``."""

    def __init__(self, *listeners: IterationListener):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration: int) -> None:
        for l in self.listeners:
            l.iteration_done(model, iteration)


class TimingListener:
    """Beyond-v0: per-iteration wall-clock (profiler hook, SURVEY.md §5.1)."""

    def __init__(self):
        self.times: list[float] = []
        self._last = None

    def iteration_done(self, model, iteration: int) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now


# --------------------------------------------------------------------------- step functions

class StepFunction(Protocol):
    """``optimize/api/StepFunction.java`` — how to move params along a
    search direction."""

    def step(self, params, direction, step_size: float): ...


class DefaultStepFunction:
    """params + step * direction (ascent orientation, reference default)."""

    def step(self, params, direction, step_size: float):
        from ..utils import tree_math as tm
        return tm.axpy(step_size, direction, params)


class NegativeDefaultStepFunction:
    """params - step * direction (descent orientation)."""

    def step(self, params, direction, step_size: float):
        from ..utils import tree_math as tm
        return tm.axpy(-step_size, direction, params)


class GradientStepFunction:
    """Step directly by the (post-processed) gradient."""

    def step(self, params, direction, step_size: float = 1.0):
        from ..utils import tree_math as tm
        return tm.axpy(step_size, direction, params)


# --------------------------------------------------------------------------- terminations

class TerminationCondition(Protocol):
    """``optimize/api/TerminationCondition.java``."""

    def terminate(self, cost: float, old_cost: float, extra: Sequence[Any]) -> bool: ...


class EpsTermination:
    """``optimize/terminations/EpsTermination.java`` — relative/absolute
    improvement below eps."""

    def __init__(self, eps: float = 1e-4, tolerance: float = 1e-10):
        self.eps, self.tolerance = eps, tolerance

    def terminate(self, cost: float, old_cost: float, extra=()) -> bool:
        if old_cost == 0:
            return abs(cost) < self.tolerance
        improvement = abs(old_cost - cost) / max(abs(old_cost), abs(cost), 1e-30)
        return improvement < self.eps


class ZeroDirection:
    """``ZeroDirection.java`` — stop when gradient direction vanishes."""

    def __init__(self, tol: float = 1e-10):
        self.tol = tol

    def terminate(self, cost: float, old_cost: float, extra=()) -> bool:
        if not extra:
            return False
        from ..utils import tree_math as tm
        return float(tm.norm2(extra[0])) < self.tol


class Norm2Termination:
    """``Norm2Termination.java`` — stop when gradient L2 below threshold."""

    def __init__(self, gradient_tolerance: float = 1e-5):
        self.gradient_tolerance = gradient_tolerance

    def terminate(self, cost: float, old_cost: float, extra=()) -> bool:
        if not extra:
            return False
        from ..utils import tree_math as tm
        return float(tm.norm2(extra[0])) < self.gradient_tolerance


# --------------------------------------------------------------------------- training evaluator

class TrainingEvaluator(Protocol):
    """``optimize/api/TrainingEvaluator.java`` — validation-driven early
    stopping."""

    def should_stop(self, iteration: int) -> bool: ...


class OutputLayerTrainingEvaluator:
    """Early stopping on validation F1.

    Capability match of ``optimize/OutputLayerTrainingEvaluator.java``: every
    ``validation_epochs`` check validation F1; stop when improvement over the
    best drops below ``improvement_threshold`` for ``patience`` consecutive
    checks.
    """

    def __init__(self, model, features, labels, validation_epochs: int = 10,
                 patience: int = 5, improvement_threshold: float = 1e-4):
        self.model = model
        self.features = features
        self.labels = labels
        self.validation_epochs = validation_epochs
        self.patience = patience
        self.improvement_threshold = improvement_threshold
        self.best_f1 = -1.0
        self.bad_checks = 0

    def should_stop(self, iteration: int) -> bool:
        if iteration == 0 or iteration % self.validation_epochs != 0:
            return False
        from ..evaluation import Evaluation
        ev = Evaluation()
        ev.eval(self.labels, self.model.output(self.features))
        f1 = ev.f1()
        if f1 > self.best_f1 + self.improvement_threshold:
            self.best_f1 = f1
            self.bad_checks = 0
        else:
            self.bad_checks += 1
        return self.bad_checks >= self.patience
