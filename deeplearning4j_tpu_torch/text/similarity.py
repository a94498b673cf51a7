"""Shared cosine-similarity / nearest-neighbor helpers for embedding models
(one implementation for Word2Vec / Glove / ParagraphVectors query APIs).

Port of ``deeplearning4j_tpu/text/similarity.py``: host code, copied as it
is.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def cosine(v1, v2) -> float:
    if v1 is None or v2 is None:
        return 0.0
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    denom = np.linalg.norm(v1) * np.linalg.norm(v2)
    return float(v1 @ v2 / denom) if denom > _EPS else 0.0


def nearest(matrix, vec, names, n: int = 10, exclude=()) -> list:
    """Top-n names by cosine similarity of their matrix rows to vec."""
    matrix = np.asarray(matrix)
    vec = np.asarray(vec)
    sims = matrix @ vec / np.maximum(
        np.linalg.norm(matrix, axis=1) * np.linalg.norm(vec), _EPS)
    exclude = set(exclude)
    out = []
    for i in np.argsort(-sims):
        name = names(int(i)) if callable(names) else names[int(i)]
        if name not in exclude:
            out.append(name)
        if len(out) >= n:
            break
    return out
