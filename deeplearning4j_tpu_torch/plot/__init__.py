"""L4 — visualization (reference: ``plot/``).

Port of ``deeplearning4j_tpu/plot``: exact t-SNE on the device,
Barnes-Hut t-SNE and the render server on the host, and the matplotlib
renderers, which import matplotlib on their first call only."""

from .tsne import BarnesHutTsne, Tsne
from .render_app import EmbeddingRenderServer, render_word_vectors
from .renderers import FilterRenderer, NeuralNetPlotter, draw_mnist_grid

__all__ = ["BarnesHutTsne", "Tsne", "EmbeddingRenderServer",
           "render_word_vectors", "FilterRenderer", "NeuralNetPlotter",
           "draw_mnist_grid"]
