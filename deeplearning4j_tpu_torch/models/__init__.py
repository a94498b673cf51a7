"""Model zoo of the port.

The DL4J families (MLP/DBN and LeNet-style conv nets built from ``nn``
configs in ``zoo.py``, the LSTM sequence model with beam search in
``lstm.py``), the flagship transformer LM (``transformer.py``: one
device, or SPMD over dp/sp/tp ranks; ``pipeline.py`` adds the pp axis)
and ``resnet.py``; the NLP embedding models live in ``..text``.
"""

from .lstm import LSTMSequenceModel
from .resnet import ResNet, ResNetConfig
from .transformer import TransformerConfig, TransformerLM
from .zoo import dbn, lenet, mlp, stacked_denoising_autoencoder

__all__ = ["LSTMSequenceModel", "ResNet", "ResNetConfig",
           "TransformerConfig", "TransformerLM",
           "dbn", "lenet", "mlp", "stacked_denoising_autoencoder"]
