"""Weight/activation renderers.

Capability match of ``plot/NeuralNetPlotter.java:32`` (weight & gradient
histograms — the reference shells out to a bundled Python/matplotlib script,
``:250``; here matplotlib is called in-process), ``plot/FilterRenderer.java``
(weight-filter grids to PNG), and ``datasets/mnist/draw`` (render
reconstructions).  All writes are headless (Agg backend) files.

Port of ``deeplearning4j_tpu/plot/renderers.py``: host code, copied.  matplotlib
is imported inside :func:`_plt`, on the first render, so importing
the package does not need it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


class NeuralNetPlotter:
    """Histogram plots of params/gradients/activations per layer."""

    def plot_network_gradient(self, params, grads, out_dir: str | Path) -> list[Path]:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        plt = _plt()
        written = []
        for i, (p, g) in enumerate(zip(params, grads)):
            fig, axes = plt.subplots(2, max(len(p), 1), figsize=(4 * len(p), 6),
                                     squeeze=False)
            for j, key in enumerate(sorted(p)):
                axes[0][j].hist(np.asarray(p[key]).ravel(), bins=50)
                axes[0][j].set_title(f"layer{i} {key}")
                axes[1][j].hist(np.asarray(g[key]).ravel(), bins=50)
                axes[1][j].set_title(f"layer{i} d{key}")
            path = out_dir / f"layer_{i}.png"
            fig.savefig(path)
            plt.close(fig)
            written.append(path)
        return written

    def plot_activations(self, activations, out_path: str | Path) -> Path:
        plt = _plt()
        fig, ax = plt.subplots(figsize=(6, 4))
        for i, a in enumerate(activations):
            ax.hist(np.asarray(a).ravel(), bins=50, alpha=0.5, label=f"layer {i}")
        ax.legend()
        fig.savefig(out_path)
        plt.close(fig)
        return Path(out_path)


class FilterRenderer:
    """Render first-layer weight filters as an image grid
    (``FilterRenderer.java``)."""

    def render_filters(self, weights, out_path: str | Path,
                       filter_shape: tuple[int, int] | None = None,
                       cols: int = 10) -> Path:
        w = np.asarray(weights)
        if w.ndim == 2:  # (n_in, n_filters) dense weights -> square images
            side = int(np.sqrt(w.shape[0]))
            filter_shape = filter_shape or (side, side)
            filters = w.T.reshape(-1, *filter_shape)
        elif w.ndim == 4:  # (fh, fw, cin, cout) conv weights
            filters = np.moveaxis(w, -1, 0)[:, :, :, 0]
        else:
            raise ValueError(f"cannot render weights of ndim {w.ndim}")
        n = filters.shape[0]
        rows = (n + cols - 1) // cols
        fh, fw = filters.shape[1:3]
        grid = np.zeros((rows * (fh + 1), cols * (fw + 1)), np.float32)
        for i, f in enumerate(filters):
            r, c = divmod(i, cols)
            lo, hi = f.min(), f.max()
            norm = (f - lo) / (hi - lo + 1e-12)
            grid[r * (fh + 1):r * (fh + 1) + fh,
                 c * (fw + 1):c * (fw + 1) + fw] = norm
        plt = _plt()
        fig, ax = plt.subplots(figsize=(cols, rows))
        ax.imshow(grid, cmap="gray")
        ax.axis("off")
        fig.savefig(out_path, bbox_inches="tight")
        plt.close(fig)
        return Path(out_path)


def draw_mnist_grid(images, out_path: str | Path, cols: int = 10,
                    side: int | None = None) -> Path:
    """Render MNIST-style images (reconstructions) in a grid
    (``datasets/mnist/draw/DrawReconstruction``)."""
    imgs = np.asarray(images)
    if imgs.ndim == 2:
        side = side or int(np.sqrt(imgs.shape[1]))
        imgs = imgs.reshape(-1, side, side)
    elif imgs.ndim == 4:
        imgs = imgs[..., 0]
    n = imgs.shape[0]
    rows = (n + cols - 1) // cols
    h, w = imgs.shape[1:3]
    grid = np.zeros((rows * (h + 1), cols * (w + 1)), np.float32)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * (h + 1):r * (h + 1) + h, c * (w + 1):c * (w + 1) + w] = im
    plt = _plt()
    fig, ax = plt.subplots(figsize=(cols, rows))
    ax.imshow(grid, cmap="gray")
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return Path(out_path)


def plot_vocab_2d(words, coords, out_path: str | Path, max_words: int = 200) -> Path:
    """Scatter labeled word embeddings (t-SNE output) — parity with the
    NLP ``plotVocab`` / dropwizard render UI's plot."""
    plt = _plt()
    coords = np.asarray(coords)
    fig, ax = plt.subplots(figsize=(10, 10))
    for w, (x, y) in list(zip(words, coords))[:max_words]:
        ax.scatter(x, y, s=4)
        ax.annotate(w, (x, y), fontsize=7)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return Path(out_path)
