"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for NVIDIA Hopper (sm_90a).

The JAX package beside it is the reference this port is held against.
This package imports ``torch`` and never ``jax`` or ``deeplearning4j_tpu``;
parameters cross between the two as numpy arrays (``models.convert``).

Ported so far:

- the flagship transformer LM (``models.transformer``): training,
  KV-cached, paged and speculative decoding, ``sample`` and
  ``beam_search``; ``serving`` (``InferenceEngine``, ``ModelServer``,
  ``ServingClient``, ``BatchScorer``, hot reload);
- ``parallel`` (checkpoints; the data-, tensor-, sequence- and
  pipeline-parallel trainers over ``torch.distributed``; the host control
  plane: the ``Driver``, the scaleout runners with their elastic wave and
  file state plane, storage and H100 provisioning), ``resilience`` (the
  supervisor, fault injection) and ``observability``;
- the DL4J network stack: ``ops`` (activations, losses, convolution,
  linalg, sampling, rng, dtypes), ``nn`` (configurations, layers,
  ``MultiLayerNetwork``), ``optimize`` (transforms, solvers, listeners),
  ``datasets`` (fetchers, IDX files, iterators), ``evaluation``,
  ``models.zoo`` and the ``python -m deeplearning4j_tpu_torch``
  ``train`` / ``evaluate`` CLI;
- ``models.resnet`` (ResNet-18/50 training, channels-last on cuDNN),
  ``models.lstm``, ``native`` (the C++ host runtime, built with ``g++``
  at first use), ``datasets.svmlight`` / ``records`` and ``text``
  (Word2Vec, GloVe, ParagraphVectors, vectorizers, the LM corpus);
- ``ops.cuda``: the kernel registry, the ``nvcc`` build and the seven
  hand-written Hopper kernels, each beside its plain PyTorch version.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
