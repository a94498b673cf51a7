"""Context windows over token streams.

Capability match of ``text/movingwindow/Windows.java:17`` + ``Window.java``:
fixed-size windows around each token (padded with edge markers), the input
representation for windowed sequence classifiers and Viterbi decoding
(``util/Viterbi.java``).

Port of ``deeplearning4j_tpu/text/windows.py``: host code, copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

PAD = "<s>"
END = "</s>"


@dataclass
class Window:
    words: list[str]
    focus_index: int
    label: str | None = None

    @property
    def focus(self) -> str:
        return self.words[self.focus_index]

    def __iter__(self):
        return iter(self.words)


def windows(tokens: Sequence[str], window_size: int = 5,
            labels: Sequence[str] | None = None) -> list[Window]:
    """One window per token, padded at the edges (``Windows.windows``)."""
    assert window_size % 2 == 1, "window size must be odd"
    half = window_size // 2
    padded = [PAD] * half + list(tokens) + [END] * half
    out = []
    for i in range(len(tokens)):
        w = Window(words=padded[i:i + window_size], focus_index=half,
                   label=labels[i] if labels is not None else None)
        out.append(w)
    return out


def window_matrix(win: Window, lookup, dim: int) -> np.ndarray:
    """Concatenate word vectors of a window (zero for unknown/pad) — the
    classic windowed-input featurization (``WindowConverter`` role)."""
    vecs = []
    for w in win.words:
        v = lookup(w)
        vecs.append(np.zeros(dim, np.float32) if v is None else np.asarray(v))
    return np.concatenate(vecs)
