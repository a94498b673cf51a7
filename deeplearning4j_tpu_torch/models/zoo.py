"""Model zoo: the classic DL4J stacks and the speculative-decoding draft.

Port of ``deeplearning4j_tpu/models/zoo.py``: ``mlp``, ``dbn`` (RBM
pretrain + softmax head), ``stacked_denoising_autoencoder`` and
``lenet`` build ``MultiLayerNetwork``s whose configurations serialize to
the reference's JSON exactly (``device=``, default ``cuda``, places
them); ``draft_lm`` makes a draft ``TransformerLM``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn.conf import (
    LayerKind,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    OptimizationAlgorithm,
    RBMHiddenUnit,
    RBMVisibleUnit,
    list_builder,
)
from ..nn.multilayer import MultiLayerNetwork
from .transformer import TransformerLM


def mlp(n_in: int, n_out: int, hidden: tuple[int, ...] = (256,), *,
        activation: str = "tanh", lr: float = 0.1, num_iterations: int = 100,
        seed: int = 123, device=None) -> MultiLayerNetwork:
    base = NeuralNetConfiguration(
        n_in=n_in, n_out=n_out, lr=lr, use_adagrad=True, momentum=0.9,
        num_iterations=num_iterations, activation=activation, seed=seed,
        optimization_algo=OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT)
    conf = (list_builder(base, len(hidden) + 1)
            .hidden_layer_sizes(*hidden)
            .override(len(hidden), kind="output", activation="softmax",
                      loss="mcxent")
            .pretrain(False)
            .build())
    return MultiLayerNetwork(conf, device=device)


def dbn(n_in: int, n_out: int, hidden: tuple[int, ...] = (500, 250), *,
        visible_unit: RBMVisibleUnit = RBMVisibleUnit.BINARY,
        hidden_unit: RBMHiddenUnit = RBMHiddenUnit.BINARY,
        k: int = 1, lr: float = 0.05, pretrain_iterations: int = 100,
        finetune_iterations: int = 200, seed: int = 123,
        device=None) -> MultiLayerNetwork:
    """Deep belief net: greedy RBM pretrain + supervised softmax finetune."""
    base = NeuralNetConfiguration(
        n_in=n_in, n_out=n_out, lr=lr, use_adagrad=True, k=k,
        kind=LayerKind.RBM, visible_unit=visible_unit, hidden_unit=hidden_unit,
        num_iterations=pretrain_iterations, activation="sigmoid", seed=seed,
        optimization_algo=OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT)
    conf = (list_builder(base, len(hidden) + 1)
            .hidden_layer_sizes(*hidden)
            .override(len(hidden), kind="output", activation="softmax",
                      loss="mcxent", num_iterations=finetune_iterations)
            .pretrain(True)
            .build())
    return MultiLayerNetwork(conf, device=device)


def stacked_denoising_autoencoder(n_in: int, n_out: int,
                                  hidden: tuple[int, ...] = (500, 250), *,
                                  corruption_level: float = 0.3,
                                  lr: float = 0.05, pretrain_iterations: int = 100,
                                  finetune_iterations: int = 200,
                                  seed: int = 123, device=None) -> MultiLayerNetwork:
    base = NeuralNetConfiguration(
        n_in=n_in, n_out=n_out, lr=lr, use_adagrad=True,
        kind=LayerKind.AUTOENCODER, corruption_level=corruption_level,
        num_iterations=pretrain_iterations, activation="sigmoid", seed=seed,
        optimization_algo=OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT)
    conf = (list_builder(base, len(hidden) + 1)
            .hidden_layer_sizes(*hidden)
            .override(len(hidden), kind="output", activation="softmax",
                      loss="mcxent", num_iterations=finetune_iterations)
            .pretrain(True)
            .build())
    return MultiLayerNetwork(conf, device=device)


def lenet(n_classes: int = 10, *, input_side: int = 28, channels: int = 1,
          num_filters: int = 6, filter_size: tuple[int, int] = (5, 5),
          pool: tuple[int, int] = (2, 2), lr: float = 0.05,
          num_iterations: int = 100, seed: int = 123,
          device=None) -> MultiLayerNetwork:
    """LeNet-style conv -> pool -> dense -> softmax on NHWC input."""
    conv_out_side = (input_side - filter_size[0] + 1) // pool[0]
    flat = conv_out_side * conv_out_side * num_filters
    conv_conf = NeuralNetConfiguration(
        kind=LayerKind.CONVOLUTION_DOWNSAMPLE, n_in=channels,
        num_filters=num_filters, filter_size=filter_size, stride=pool,
        activation="relu", lr=lr, seed=seed,
        num_iterations=num_iterations,
        optimization_algo=OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT)
    dense_conf = NeuralNetConfiguration(
        kind=LayerKind.DENSE, n_in=flat, n_out=120, activation="tanh", lr=lr,
        seed=seed + 1, num_iterations=num_iterations,
        optimization_algo=OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT)
    out_conf = NeuralNetConfiguration(
        kind=LayerKind.OUTPUT, n_in=120, n_out=n_classes,
        activation="softmax", loss="mcxent", lr=lr, seed=seed + 2,
        num_iterations=num_iterations,
        optimization_algo=OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT)
    conf = MultiLayerConfiguration(
        confs=(conv_conf, dense_conf, out_conf), pretrain=False,
        preprocessors={0: "flatten"})  # conv output -> dense input
    return MultiLayerNetwork(conf, device=device)




def draft_lm(target_cfg, *, n_layers: int = 1, width_divisor: int = 2,
             seed: int = 0, device=None):
    """A shallower, thinner ``TransformerLM`` sharing the target's
    ``vocab_size`` and ``max_len`` (the speculative engine's contract:
    the draft proposes token ids the target verifies, and its KV cache is
    indexed by the same positions).  Returns ``(model, params)`` with the
    params drawn from a CPU generator seeded ``seed`` and placed on
    ``device`` (default ``cuda``).  A bad draft only lowers
    ``serving.spec_accept_len``; it never changes served tokens."""
    heads = max(1, target_cfg.n_heads // width_divisor)
    d_model = max(heads * (target_cfg.d_model // target_cfg.n_heads),
                  target_cfg.d_model // width_divisor)
    d_model -= d_model % heads
    cfg = dataclasses.replace(
        target_cfg, n_layers=max(1, n_layers), d_model=d_model,
        n_heads=heads, d_ff=max(d_model, target_cfg.d_ff // width_divisor),
        remat=False)
    model = TransformerLM(cfg, device=device)
    return model, model.init(torch.Generator().manual_seed(seed))
