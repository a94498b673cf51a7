"""The JAX package's side of the model-parallel parity tests: the same
fixtures as ``tests/torch_ranks.py``'s ``mp_*`` jobs, run through the
reference's ``TransformerLM`` / ``PipelinedTransformerLM`` on
``jax.devices()[:n]`` (the conftest's 8 virtual CPU devices), and the
port's one-device step in this process.  Every result is numpy: global
params (the pipeline's stacked), losses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from deeplearning4j_tpu.models import pipeline as jpl
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.optimize import transforms as JT
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JSpec
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake
from torch_ranks import TXS

#: across the packages on the same mesh, float32 (the data-parallel tests'
#: window, tests/test_torch_parallel.py)
TOL = 1e-5
#: a mesh against one device: the reference's own window
#: (``tests/test_transformer.py:149-153``)
RTOL_MESH = ATOL_MESH = 2e-4


def tiny(**kw):
    """The reference tests' tiny config (``tests/test_transformer.py``)."""
    out = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
               max_len=32, remat=False)
    out.update(kw)
    return out


def lm_batches(cfg_kw, batch, seq, steps=1, seed=0):
    out = []
    for s in range(steps):
        rng = np.random.default_rng(seed + s)
        toks = rng.integers(0, cfg_kw["vocab_size"], (batch, seq)
                            ).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def init_np(cfg_kw, seed=1, n_classes=0, stacked=False):
    """Global numpy params drawn by the reference (``n_classes``: the
    ``{"backbone", "head"}`` finetune tree)."""
    cfg = jtr.TransformerConfig(dtype=jnp.float32, **cfg_kw)
    model = jtr.TransformerLM(cfg)
    key = jax.random.key(seed)
    tree = (model.init_finetune(key, n_classes) if n_classes
            else model.init(key))
    if stacked:
        if n_classes:
            tree["backbone"] = jpl.stack_layers(tree["backbone"])
        else:
            tree = jpl.stack_layers(tree)
    return np_tree(tree)


def jax_train(spec, params, batches, cfg_kw, tx="momentum", zero1=False,
              finetune=False, n_micro=0):
    """The reference's steps over ``spec`` (None: one device); (losses,
    global params)."""
    cfg = jtr.TransformerConfig(dtype=jnp.float32, **cfg_kw)
    mesh = None
    if spec is not None:
        n = int(np.prod(list(spec.values())))
        mesh = jmake(JSpec(**spec), devices=jax.devices()[:n])
    model = (jpl.PipelinedTransformerLM(cfg, mesh, n_micro=n_micro)
             if n_micro else jtr.TransformerLM(cfg, mesh))
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    if mesh is not None:
        tree = model.place(tree, model.finetune_specs() if finetune
                           else model._specs())
    t = TXS[tx](JT)
    step = (model.build_finetune_step(t) if finetune
            else model.build_train_step(t, zero1=zero1))
    opt = model.init_opt_zero1(tree, t) if zero1 else model.init_opt(tree, t)
    losses = []
    for a, b in batches:
        tree, opt, loss = step(tree, opt, jnp.asarray(a), jnp.asarray(b))
        losses.append(float(loss))
    return losses, np_tree(tree)


def port_one_device(params, batches, cfg_kw, tx="momentum",
                    finetune=False):
    """The port's one-device steps in this process; (losses, params)."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.models.convert import (params_from_numpy,
                                                         params_to_numpy)
    from deeplearning4j_tpu_torch.optimize import transforms as T

    cfg = ttr.TransformerConfig(dtype=torch.float32, **cfg_kw)
    model = ttr.TransformerLM(cfg, device="cpu")
    tree = params_from_numpy(params, "cpu")
    t = TXS[tx](T)
    step = (model.build_finetune_step(t) if finetune
            else model.build_train_step(t))
    opt = model.init_opt(tree, t)
    losses = []
    for a, b in batches:
        tree, opt, loss = step(tree, opt, torch.as_tensor(a),
                               torch.as_tensor(b))
        losses.append(loss.item())
    return losses, params_to_numpy(tree)


def close_trees(got, want, atol=TOL, rtol=0.0, what=""):
    ga = jax.tree_util.tree_leaves(got)
    wa = jax.tree_util.tree_leaves(want)
    assert len(ga) == len(wa), (len(ga), len(wa))
    for i, (a, b) in enumerate(zip(ga, wa)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   rtol=rtol, err_msg=f"{what} leaf {i}")


def close(got, want, atol=TOL, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)
