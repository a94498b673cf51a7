"""The DL4J network stack: configs, layers, the MultiLayerNetwork container.

Port of ``deeplearning4j_tpu/nn``: layers are pure ``init(gen) ->
params`` / ``activate(params, x)`` modules over dicts of tensors, and the
container trains them with ``torch.func`` gradients on the GPU.
"""

from .conf import (
    ConfOverride,
    LayerConfig,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from .multilayer import MultiLayerNetwork

__all__ = [
    "ConfOverride",
    "LayerConfig",
    "MultiLayerConfiguration",
    "NeuralNetConfiguration",
    "MultiLayerNetwork",
]
