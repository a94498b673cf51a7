"""Solvers: the optimization loops.

Port of ``deeplearning4j_tpu/optimize/solvers.py``: the shared
``BaseOptimizer`` loop, ``GradientAscent`` / ``IterationGradientDescent``,
Polak-Ribière ``ConjugateGradient``, ``LBFGS`` (two-loop recursion, m=10),
``BackTrackLineSearch`` (Armijo) and ``StochasticHessianFree`` (truncated
CG on Gauss-Newton products).  Every solver minimizes a loss.  An
objective is ``(params, gen, *batch) -> (loss, grads)``; with
``batches=[(x, y), ...]`` each outer iteration takes the next batch, and
its line-search probes and curvature products all use that batch.

The line search, CG's restart test and L-BFGS read scalars on the host
each iteration, as the reference does.  Hessian-free's truncated CG does
not: the reference's ``lax.while_loop`` becomes ``cg_iterations`` steps
whose stop condition is a device mask that freezes the carry, so the
solve gives the while loop's result with no host read; its curvature
products are ``torch.func.jvp`` / ``vjp`` (``utils.autodiff``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch

from ..nn.conf import NeuralNetConfiguration, OptimizationAlgorithm
from ..utils import tree_math as tm
from ..utils.autodiff import grad, jvp, vjp
from ..utils.tree_math import tree_leaves, tree_map
from . import transforms as tfm
from .api import EpsTermination, IterationListener, TerminationCondition

log = logging.getLogger(__name__)

# Objective: (params, gen, *batch) -> (loss, grads)
Objective = Callable[..., tuple[torch.Tensor, Any]]


@dataclass
class OptimizeResult:
    params: Any
    score: float
    iterations: int
    converged: bool
    history: list[float] = field(default_factory=list)


def _default_gen(params, seed: int) -> torch.Generator:
    """A generator seeded ``seed`` on the device of ``params``."""
    dev = tree_leaves(params)[0].device
    return torch.Generator(device=dev).manual_seed(seed)


# --------------------------------------------------------------------------- line search

class BackTrackLineSearch:
    """Armijo backtracking: shrink the step until f(p + step*d) <=
    f(p) + c1*step*g·d, with relTol shrinkage and max-step clamping."""

    def __init__(self, value_fn: Callable[[Any], torch.Tensor],
                 max_iterations: int = 5, c1: float = 1e-4,
                 rel_tol: float = 0.5, step_max: float = 100.0):
        self.value_fn = value_fn
        self.max_iterations = max_iterations
        self.c1 = c1
        self.rel_tol = rel_tol
        self.step_max = step_max

    def optimize(self, params, direction, grads,
                 initial_step: float = 1.0) -> float:
        """Returns a step size along ``direction`` (a descent direction)."""
        f0 = float(self.value_fn(params))
        slope = float(tm.dot(grads, direction))
        if slope >= 0:
            # not a descent direction
            return 0.0
        dnorm = float(tm.norm2(direction))
        step = min(initial_step, self.step_max / max(dnorm, 1e-12))
        for _ in range(self.max_iterations):
            trial = tm.axpy(step, direction, params)
            f1 = float(self.value_fn(trial))
            if f1 <= f0 + self.c1 * step * slope:
                return step
            step *= self.rel_tol
        return step


# --------------------------------------------------------------------------- base loop

class BaseOptimizer:
    """The shared iteration loop: loss and gradient, the conf's transform
    chain, a line search along the step, terminations, listeners."""

    name = "base"
    use_line_search = False

    def __init__(self, conf: NeuralNetConfiguration, objective: Objective,
                 listeners: Sequence[IterationListener] = (),
                 terminations: Sequence[TerminationCondition] = (),
                 transform: tfm.GradientTransform | None = None,
                 training_evaluator=None, batches=None):
        self.conf = conf
        self.objective = objective
        self.listeners = list(listeners)
        self.terminations = list(terminations) or [EpsTermination()]
        self.transform = (transform if transform is not None
                          else tfm.from_conf(conf))
        self.training_evaluator = training_evaluator
        self.batches = list(batches) if batches is not None else None
        self._score = float("inf")
        # The line search probes the objective's value; when the conf
        # regularizes, the value carries the same L2 term the transform
        # chain folds into the direction, or Armijo measures another
        # objective than the one descended.
        if conf.use_regularization and conf.l2 > 0:
            l2 = conf.l2
            self._val = (lambda p, k, *b: objective(p, k, *b)[0]
                         + tfm.l2_penalty(l2, p))
        else:
            self._val = lambda p, k, *b: objective(p, k, *b)[0]

    def _batch(self, it: int) -> tuple:
        """The objective's extra arguments for iteration ``it``: the next
        mini-batch in the cycle, or () in whole-objective mode."""
        if not self.batches:
            return ()
        return tuple(self.batches[it % len(self.batches)])

    def score(self) -> float:
        return self._score

    # direction selection hook — first-order: post-processed negative gradient
    def setup(self, params):
        return {"tstate": self.transform.init(params)}

    def direction(self, params, grads, state: dict):
        updates, state["tstate"] = self.transform.update(
            grads, state["tstate"], params, state.get("iteration", 0))
        return tm.neg(updates), state  # descent direction

    def optimize(self, params, gen=None) -> OptimizeResult:
        gen = gen if gen is not None else _default_gen(params, self.conf.seed)
        state = self.setup(params)
        old_score = float("inf")
        history: list[float] = []
        converged = False
        it = 0
        for it in range(self.conf.num_iterations):
            state["iteration"] = it
            b = self._batch(it)
            loss, grads = self.objective(params, gen, *b)
            self._score = float(loss)
            history.append(self._score)
            direction, state = self.direction(params, grads, state)
            if self.use_line_search:
                ls = BackTrackLineSearch(lambda p, b=b: self._val(p, gen, *b))
                # the slope is d(probed objective)·direction: with the L2
                # term the probed value carries
                probe_grads = grads
                if self.conf.use_regularization and self.conf.l2 > 0:
                    probe_grads = tfm.l2_grad(self.conf.l2, grads, params)
                step = ls.optimize(params, direction, probe_grads,
                                   initial_step=1.0)
                params = tm.axpy(step, direction, params)
            else:
                params = tm.add(params, direction)
            for l in self.listeners:
                l.iteration_done(self, it)
            if self.training_evaluator is not None \
                    and self.training_evaluator.should_stop(it):
                converged = True
                break
            if it > 0 and any(t.terminate(self._score, old_score, (grads,))
                              for t in self.terminations):
                converged = True
                break
            old_score = self._score
        return OptimizeResult(params, self._score, it + 1, converged, history)


class IterationGradientDescent(BaseOptimizer):
    """Plain per-iteration GD with the transform chain, no line search."""

    name = "iteration_gradient_descent"


class GradientAscent(BaseOptimizer):
    """Line-searched steepest descent (the reference's name: it ascends
    the negated objective)."""

    name = "gradient_descent"
    use_line_search = True


class ConjugateGradient(BaseOptimizer):
    """Polak-Ribière nonlinear CG with Armijo line search and a restart
    on non-descent directions."""

    name = "conjugate_gradient"
    use_line_search = True

    def setup(self, params):
        s = super().setup(params)
        s["prev_grad"] = None
        s["prev_dir"] = None
        return s

    def direction(self, params, grads, state):
        g = grads
        if state["prev_grad"] is None:
            d = tm.neg(g)
        else:
            gg_prev = tm.dot(state["prev_grad"], state["prev_grad"])
            beta = tm.dot(g, tm.sub(g, state["prev_grad"])) / (gg_prev + 1e-30)
            beta = torch.clamp(beta, min=0.0)  # PR+ restart
            d = tm.axpy(beta, state["prev_dir"], tm.neg(g))
            if float(tm.dot(g, d)) >= 0:  # not descent → restart
                d = tm.neg(g)
        state["prev_grad"], state["prev_dir"] = g, d
        return d, state


class LBFGS(BaseOptimizer):
    """Limited-memory BFGS two-loop recursion, memory m=10."""

    name = "lbfgs"
    use_line_search = True
    m = 10

    def setup(self, params):
        s = super().setup(params)
        s["s_hist"], s["y_hist"] = [], []
        s["prev_params"], s["prev_grad"] = None, None
        return s

    def direction(self, params, grads, state):
        if state["prev_params"] is not None:
            sk = tm.sub(params, state["prev_params"])
            yk = tm.sub(grads, state["prev_grad"])
            if float(tm.dot(sk, yk)) > 1e-10:
                state["s_hist"].append(sk)
                state["y_hist"].append(yk)
                if len(state["s_hist"]) > self.m:
                    state["s_hist"].pop(0)
                    state["y_hist"].pop(0)
        state["prev_params"], state["prev_grad"] = params, grads

        q = grads
        alphas = []
        for sk, yk in zip(reversed(state["s_hist"]),
                          reversed(state["y_hist"])):
            rho = 1.0 / float(tm.dot(yk, sk))
            alpha = rho * float(tm.dot(sk, q))
            q = tm.axpy(-alpha, yk, q)
            alphas.append((alpha, rho, sk, yk))
        if state["s_hist"]:
            sk, yk = state["s_hist"][-1], state["y_hist"][-1]
            gamma = float(tm.dot(sk, yk)) / (float(tm.dot(yk, yk)) + 1e-30)
            q = tm.scale(gamma, q)
        for alpha, rho, sk, yk in reversed(alphas):
            beta = rho * float(tm.dot(yk, q))
            q = tm.axpy(alpha - beta, sk, q)
        return tm.neg(q), state


class StochasticHessianFree(BaseOptimizer):
    """Hessian-free (truncated-Newton) optimization.

    Solves (G + λI) d = -g by truncated CG, G the Gauss-Newton matrix
    when the objective comes split as ``gauss_newton=(predict,
    loss_out)``: ``predict(params, gen, *batch) -> z`` (the network up to
    the final pre-activation) and ``loss_out(z, *batch) -> scalar``
    (convex in z).  Without the split, true Hessian-vector products
    (forward over reverse), safe only for convex-ish objectives.  The CG
    solve makes no host read (see the module docstring); the damping
    follows the reduction ratio, from ``damping`` (the conf's
    ``damping_factor``, 100 by default)."""

    name = "hessian_free"
    cg_iterations = 20

    def __init__(self, *args, damping: float = 100.0, gauss_newton=None,
                 **kw):
        super().__init__(*args, **kw)
        self.damping = damping
        self.gauss_newton = gauss_newton

    def _cvp(self, params, vec, gen, b=()):
        """Curvature-vector product: Gauss-Newton ``J^T H_L J v`` with the
        split, else the Hessian-vector product.  ``b`` is the iteration's
        mini-batch (empty in whole-objective mode)."""
        if self.gauss_newton is not None:
            predict, loss_out = self.gauss_newton
            z, jv = jvp(lambda p: predict(p, gen, *b), (params,), (vec,))
            _, hjv = jvp(grad(lambda zz: loss_out(zz, *b)), (z,), (jv,))
            _, vjp_fn = vjp(lambda p: predict(p, gen, *b), params)
            (gv,) = vjp_fn(hjv)
            return gv
        _, hv = jvp(lambda p: self.objective(p, gen, *b)[1], (params,),
                    (vec,))
        return hv

    def _cg_solve(self, params, grads, gen, damping, batch=()):
        """Truncated CG on (G + λI) x = -g: ``cg_iterations`` steps, each
        applied only while the reference's loop condition (the direction
        still positive-curvature, ``rs > 1e-10``) holds on the device."""
        lam = float(damping)
        b = tm.neg(grads)
        rs_old = tm.dot(b, b)
        x, r, p = tm.zeros_like(b), b, b
        live = torch.ones((), dtype=torch.bool, device=rs_old.device)

        def keep(go, new, old):
            return tree_map(lambda n, o: torch.where(go, n, o), new, old)

        for _ in range(self.cg_iterations):
            go = live & (rs_old > 1e-10)
            hp = tm.axpy(lam, p, self._cvp(params, p, gen, batch))
            denom = tm.dot(p, hp)
            live_n = denom > 1e-20
            alpha = torch.where(live_n, rs_old / torch.clamp(denom, min=1e-20),
                                0.0)
            x_n = tm.axpy(alpha, p, x)
            r_n = tm.axpy(-alpha, hp, r)
            rs_new = torch.where(live_n, tm.dot(r_n, r_n), 0.0)
            beta = rs_new / torch.clamp(rs_old, min=1e-30)
            p_n = tm.axpy(beta, p, r_n)
            x, r, p = keep(go, x_n, x), keep(go, r_n, r), keep(go, p_n, p)
            rs_old = torch.where(go, rs_new, rs_old)
            live = torch.where(go, live_n, live)
        return x

    def _model_quantities(self, params, d, grads, gen, damping, batch=()):
        """(new_loss, damped quadratic-model reduction), on the device."""
        new_loss = self.objective(tm.add(params, d), gen, *batch)[0]
        gd = tm.dot(grads, d)
        dGd = tm.dot(d, tm.axpy(float(damping), d,
                                self._cvp(params, d, gen, batch)))
        return new_loss, gd + 0.5 * dGd

    def optimize(self, params, gen=None) -> OptimizeResult:
        gen = gen if gen is not None else _default_gen(params, self.conf.seed)
        history: list[float] = []
        converged = False
        old_score = float("inf")
        it = 0
        for it in range(self.conf.num_iterations):
            b = self._batch(it)
            loss, grads = self.objective(params, gen, *b)
            self._score = float(loss)
            history.append(self._score)
            d = self._cg_solve(params, grads, gen, self.damping, b)
            # quadratic-model reduction ratio → damping update
            new_loss_dev, quad_dev = self._model_quantities(
                params, d, grads, gen, self.damping, b)
            new_loss, quad = float(new_loss_dev), float(quad_dev)
            rho = (new_loss - self._score) / quad if quad != 0 else 0.0
            if rho > 0.75:
                self.damping *= 2.0 / 3.0
            elif rho < 0.25:
                self.damping *= 1.5
            if new_loss < self._score:
                params = tm.add(params, d)
            for l in self.listeners:
                l.iteration_done(self, it)
            if it > 0 and any(t.terminate(self._score, old_score, (grads,))
                              for t in self.terminations):
                converged = True
                break
            old_score = self._score
        return OptimizeResult(params, self._score, it + 1, converged, history)


# --------------------------------------------------------------------------- Solver facade

_ALGOS = {
    OptimizationAlgorithm.GRADIENT_DESCENT: GradientAscent,
    OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT: IterationGradientDescent,
    OptimizationAlgorithm.CONJUGATE_GRADIENT: ConjugateGradient,
    OptimizationAlgorithm.LBFGS: LBFGS,
    OptimizationAlgorithm.HESSIAN_FREE: StochasticHessianFree,
}


class Solver:
    """Dispatch ``conf.optimization_algo`` to an optimizer instance."""

    def __init__(self, conf: NeuralNetConfiguration, objective: Objective,
                 **kw):
        self.conf = conf
        self.objective = objective
        self.kw = kw

    def build(self) -> BaseOptimizer:
        cls = _ALGOS[self.conf.optimization_algo]
        return cls(self.conf, self.objective, **self.kw)

    def optimize(self, params, gen=None) -> OptimizeResult:
        return self.build().optimize(params, gen)
