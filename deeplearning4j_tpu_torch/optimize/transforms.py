"""Gradient transforms (optax-style) over parameter trees of tensors.

Port of ``deeplearning4j_tpu/optimize/transforms.py``: each transform is
an ``(init, update)`` pair, ``chain`` composes them, ``apply_updates``
subtracts the result, and ``from_conf`` assembles the DL4J
post-processing chain of a ``NeuralNetConfiguration`` (AdaGrad or plain
LR, momentum, L2, the unit-norm clip).  Trees are nested dicts/lists/tuples of tensors
(``utils.tree_math``).  Optimizer state is always f32, as in the
reference.  Updates are functional, as in JAX: every call returns new
tensors and leaves its inputs untouched; the heavy per-leaf arithmetic
runs as ``torch._foreach_*`` calls over all leaves at once.

Schedules are plain Python callables ``step -> lr`` evaluated in float32
arithmetic (numpy scalars), as the reference's jnp schedules evaluate
them; the step count of the trainers is a Python int.  A stateful
transform declares ``state_spec`` (param specs -> state specs, the
structure ``init`` returns), which ``state_shardings`` and
``init_sharded`` use to place optimizer state as the ZeRO trainer's flat
param chunks are placed: each rank materializes its chunk only.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import TYPE_CHECKING, Any, Callable, NamedTuple

import numpy as np
import torch

from ..utils import tree_math as tm
from ..utils.tree_math import tree_leaves, tree_map, tree_unflatten

if TYPE_CHECKING:
    from ..nn.conf import NeuralNetConfiguration


class GradientTransform(NamedTuple):
    init: Callable[[Any], Any]           # params -> state
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    # (grads, state, params, iteration) -> (new_grads, new_state)
    state_spec: Callable[[Any], Any] | None = None
    # param specs -> state specs (init's structure); None: no state


def _empty_spec(param_specs):
    return ()


# --------------------------------------------------------------------- decay mask
#
# "Which leaves get weight decay" defaults to ndim >= 2 (weight matrices
# yes, biases and LayerNorms no).  Trainers that lay parameters out
# differently push a bool tree through ``decay_mask_override``.  A
# ContextVar keeps two threads (or two models) from seeing each other's
# override.
_DECAY_MASK_STACK: ContextVar[tuple] = ContextVar("decay_mask_stack",
                                                  default=())


@contextmanager
def decay_mask_override(mask):
    """Override the decay-leaf choice for ``update`` calls made inside this
    context.  ``mask``: bool tree matching the params handed to update
    (None keeps the ndim >= 2 default)."""
    token = _DECAY_MASK_STACK.set(_DECAY_MASK_STACK.get() + (mask,))
    try:
        yield
    finally:
        _DECAY_MASK_STACK.reset(token)


def decay_leaf_mask(params):
    """Effective decay mask for ``params``: the innermost active override,
    else the ndim >= 2 heuristic."""
    stack = _DECAY_MASK_STACK.get()
    if stack and stack[-1] is not None:
        return stack[-1]
    return tree_map(lambda w: w.dim() >= 2, params)


def state_shardings(transform: GradientTransform, params, leaf_spec, mesh):
    """``NamedSharding`` tree for ``transform.init(params)``, from
    ``state_spec`` with every param leaf placed as ``leaf_spec`` (the ZeRO
    trainer hands the FLATTENED params and ``P('dp')``).  Raises when the
    spec tree and the state disagree in leaf count (a stateful transform
    in the chain without its ``state_spec``)."""
    from ..parallel.mesh import NamedSharding

    param_specs = tree_map(lambda _: leaf_spec, params)
    specs = (transform.state_spec or _empty_spec)(param_specs)
    state = transform.init(tree_map(
        lambda p: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta"),
        params))
    spec_leaves = tree_leaves(specs)
    if len(spec_leaves) != len(tree_leaves(state)):
        raise ValueError(
            f"state_spec produced {len(spec_leaves)} leaf specs for a state "
            f"with {len(tree_leaves(state))} leaves — a stateful transform "
            "in the chain is missing (or mis-declaring) its state_spec")
    return tree_unflatten(state, [NamedSharding(mesh, s)
                                  for s in spec_leaves])


def init_sharded(transform: GradientTransform, params, leaf_spec, mesh):
    """``transform.init`` over this rank's blocks of ``params`` placed as
    ``leaf_spec``: every state leaf is born rank-local (no full-size
    state on any rank), in the placement ``state_shardings`` derives."""
    from ..parallel.mesh import NamedSharding, local_block

    state_shardings(transform, params, leaf_spec, mesh)   # the contract
    sharding = NamedSharding(mesh, leaf_spec)
    return transform.init(tree_map(lambda p: local_block(p, sharding),
                                   params))


def chain(*transforms: GradientTransform) -> GradientTransform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None, iteration=0):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s2 = t.update(grads, s, params, iteration)
            new_state.append(s2)
        return grads, tuple(new_state)

    def state_spec(param_specs):
        return tuple((t.state_spec or _empty_spec)(param_specs)
                     for t in transforms)

    return GradientTransform(init, update, state_spec)


def identity() -> GradientTransform:
    return GradientTransform(lambda p: (), lambda g, s, p=None, i=0: (g, s))


def _scaled(grads, factor):
    """``grads * factor`` (a float or a 0-d tensor) over every leaf."""
    return tree_unflatten(grads, torch._foreach_mul(tree_leaves(grads),
                                                    factor))


def scale(factor: float) -> GradientTransform:
    return GradientTransform(
        lambda p: (), lambda g, s, p=None, i=0: (_scaled(g, factor), s))


def _f32_zeros(params):
    """Optimizer state is always f32, even for bf16 params."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _f32_leaves(tree) -> list:
    return [g.float() for g in tree_leaves(tree)]


def adagrad(lr: float, eps: float = 1e-6) -> GradientTransform:
    """Per-parameter adaptive LR: ``g * lr / sqrt(sum g^2 + eps)``."""

    def update(grads, hist, params=None, iteration=0):
        hist = tree_map(lambda h, g: h + g.float() ** 2, hist, grads)
        out = tree_map(lambda g, h: lr * g * torch.rsqrt(h + eps), grads, hist)
        return out, hist

    return GradientTransform(_f32_zeros, update, lambda ps: ps)


def sgd_lr(lr: float) -> GradientTransform:
    return scale(lr)


# --------------------------------------------------------------------- schedules

def _f32(x):
    return np.float32(x)


def constant_schedule(lr: float) -> Callable[[Any], float]:
    return lambda step: float(_f32(lr))


def _warmup(peak, warmup_steps, total_steps, step):
    """(step, warm, frac) of the warmup schedules, in float32."""
    step = _f32(step)
    warm = _f32(peak) * step / _f32(max(warmup_steps, 1))
    frac = (step - _f32(warmup_steps)) / _f32(max(total_steps - warmup_steps,
                                                 1))
    return step, warm, np.clip(frac, _f32(0.0), _f32(1.0))


def warmup_linear(peak: float, warmup_steps: int, total_steps: int,
                  end: float = 0.0) -> Callable[[Any], float]:
    """Linear warmup 0 -> peak then linear decay peak -> end."""

    def sched(step):
        step, warm, frac = _warmup(peak, warmup_steps, total_steps, step)
        decay = _f32(peak) + (_f32(end) - _f32(peak)) * frac
        return float(warm if step < warmup_steps else decay)

    return sched


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  end: float = 0.0) -> Callable[[Any], float]:
    """Linear warmup then cosine decay to ``end``."""

    def sched(step):
        step, warm, frac = _warmup(peak, warmup_steps, total_steps, step)
        decay = _f32(end) + _f32(0.5) * (_f32(peak) - _f32(end)) * (
            _f32(1.0) + np.cos(_f32(np.pi) * frac))
        return float(warm if step < warmup_steps else decay)

    return sched


def scale_by_schedule(lr) -> GradientTransform:
    """Multiply updates by ``lr`` (float) or ``lr(iteration)`` (schedule)."""

    def update(grads, s, params=None, iteration=0):
        factor = lr(iteration) if callable(lr) else lr
        return _scaled(grads, factor), s

    return GradientTransform(lambda p: (), update)


# --------------------------------------------------------------------- adam family

def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransform:
    """Adam moment rescaling with bias correction driven by ``iteration``.
    State ``(mu, nu)``: f32 trees mirroring the params."""

    def init(params):
        return (_f32_zeros(params), _f32_zeros(params))

    def update(grads, state, params=None, iteration=0):
        mu, nu = state
        g32 = _f32_leaves(grads)
        mu_l = torch._foreach_add(torch._foreach_mul(tree_leaves(mu), b1),
                                  torch._foreach_mul(g32, 1 - b1))
        gg = torch._foreach_mul(torch._foreach_mul(g32, 1 - b2), g32)
        nu_l = torch._foreach_add(torch._foreach_mul(tree_leaves(nu), b2), gg)
        t = _f32(iteration) + _f32(1.0)
        c1 = float(_f32(1.0) - np.power(_f32(b1), t))
        c2 = float(_f32(1.0) - np.power(_f32(b2), t))
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu_l, c2)), eps)
        out = torch._foreach_div(torch._foreach_div(mu_l, c1), den)
        return (tree_unflatten(grads, out),
                (tree_unflatten(mu, mu_l), tree_unflatten(nu, nu_l)))

    return GradientTransform(init, update, lambda ps: (ps, ps))


def add_decayed_weights(wd: float) -> GradientTransform:
    """Decoupled weight decay (AdamW): ``updates += wd * w`` on the
    weight-class leaves (``decay_leaf_mask``) only."""

    def update(grads, s, params=None, iteration=0):
        if params is None or wd == 0.0:
            return grads, s
        return tree_map(lambda g, w, m: g + wd * w.to(g.dtype) if m else g,
                        grads, params, decay_leaf_mask(params)), s

    return GradientTransform(lambda p: (), update)


def adam(lr=1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransform:
    """Adam: moment rescaling then LR (float or schedule)."""
    return chain(scale_by_adam(b1, b2, eps), scale_by_schedule(lr))


def adamw(lr=1e-3, weight_decay: float = 0.01, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8) -> GradientTransform:
    """AdamW: decoupled weight decay added after moment rescaling, both
    scaled by the schedule."""
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_schedule(lr))


def momentum(base: float,
             schedule: dict[int, float] | None = None) -> GradientTransform:
    """Heavy-ball momentum ``v = m*v + g`` (emits v), with an optional
    piecewise-constant ``{iteration: momentum}`` schedule."""
    schedule = dict(schedule or {})

    def momentum_at(iteration):
        m = base
        for it in sorted(schedule):
            if it <= iteration:
                m = schedule[it]
        return m

    def update(grads, vel, params=None, iteration=0):
        v = torch._foreach_add(
            torch._foreach_mul(tree_leaves(vel), momentum_at(iteration)),
            _f32_leaves(grads))
        return tree_unflatten(grads, v), tree_unflatten(vel, v)

    return GradientTransform(_f32_zeros, update, lambda ps: ps)


def weight_decay(l2: float) -> GradientTransform:
    """L2 regularization ``g += l2 * w`` on the weight-class leaves
    (``decay_leaf_mask``): biases stay unregularized, as in the reference."""

    def update(grads, s, params=None, iteration=0):
        if params is None:
            return grads, s
        return l2_grad(l2, grads, params), s

    return GradientTransform(lambda p: (), update)


def l2_grad(l2: float, grads, params):
    """``g + l2*w`` over the leaves ``weight_decay`` touches."""
    return tree_map(lambda g, w, m: g + l2 * w if m else g,
                    grads, params, decay_leaf_mask(params))


def l2_penalty(l2: float, params) -> torch.Tensor:
    """``0.5*l2*||W||^2`` over the leaves ``weight_decay`` touches: the
    value that matches the decayed direction (line-search probes)."""
    leaves = [0.5 * l2 * torch.sum(w * w)
              for w, m in zip(tree_leaves(params),
                              tree_leaves(decay_leaf_mask(params)))
              if m]
    return sum(leaves) if leaves else torch.zeros(())


def clip_unit_norm() -> GradientTransform:
    """``constrainGradientToUnitNorm``: scale the whole gradient to unit L2."""

    def update(grads, s, params=None, iteration=0):
        return tm.unit_norm(grads), s

    return GradientTransform(lambda p: (), update)


def clip_by_global_norm(max_norm: float) -> GradientTransform:
    def update(grads, s, params=None, iteration=0):
        return tm.clip_by_global_norm(grads, max_norm), s

    return GradientTransform(lambda p: (), update)


def divide_by_batch(batch_size_fn: Callable[[], float] | float
                    ) -> GradientTransform:
    def update(grads, s, params=None, iteration=0):
        bs = batch_size_fn() if callable(batch_size_fn) else batch_size_fn
        return tree_map(lambda g: g / bs, grads), s

    return GradientTransform(lambda p: (), update)


def from_conf(conf: NeuralNetConfiguration) -> GradientTransform:
    """The reference's post-processing chain of a conf, in its order:
    AdaGrad (or plain LR), momentum, L2 — added after the adaptive-LR
    scaling, so the decay term is not rescaled by the per-param learning
    rate — then the unit-norm clip."""
    parts: list[GradientTransform] = []
    if conf.use_adagrad:
        parts.append(adagrad(conf.lr))
    else:
        parts.append(sgd_lr(conf.lr))
    if conf.momentum > 0 or conf.momentum_schedule:
        parts.append(momentum(conf.momentum, conf.momentum_schedule))
    if conf.use_regularization and conf.l2 > 0:
        parts.append(weight_decay(conf.l2))
    if conf.constrain_gradient_to_unit_norm:
        parts.append(clip_unit_norm())
    return chain(*parts) if parts else identity()


def apply_updates(params, updates):
    """Gradient-descent application: ``params - updates`` (new tensors)."""
    p = tree_leaves(params)
    u = [x.to(w.dtype) for x, w in zip(tree_leaves(updates), p)]
    return tree_unflatten(params, torch._foreach_sub(p, u))
