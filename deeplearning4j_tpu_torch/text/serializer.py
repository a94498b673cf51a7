"""Word-vector serialization — Google word2vec text & binary formats.

Capability match of ``models/embeddings/loader/WordVectorSerializer.java:
27,40,269,303,337``: round-trip to the original word2vec C formats so vectors
interchange with the wider ecosystem.

Port of ``deeplearning4j_tpu/text/serializer.py``: the same text and
binary bytes, so each package loads the other's files; a loaded model's
``syn0`` is a tensor on the caller's device.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def save_txt(words: list[str], vectors: np.ndarray, path: str | Path) -> None:
    """One 'word v1 v2 ...' line per word (writeWordVectors)."""
    vectors = np.asarray(vectors)
    with open(path, "w", encoding="utf-8") as f:
        for w, vec in zip(words, vectors):
            f.write(w + " " + " ".join(f"{x:.6g}" for x in vec) + "\n")


def load_txt(path: str | Path) -> tuple[list[str], np.ndarray]:
    words, rows = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 2:
                continue
            if len(words) == 0 and len(parts) == 2 and all(
                    p.isdigit() for p in parts):
                continue  # optional "count dim" header
            words.append(parts[0])
            rows.append(np.array(parts[1:], dtype=np.float32))
    return words, np.stack(rows)


def save_google_binary(words: list[str], vectors: np.ndarray,
                       path: str | Path) -> None:
    """word2vec C binary: header 'count dim\\n', then per word
    'word ' + dim float32s (loadGoogleModel's inverse)."""
    vectors = np.asarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    with open(path, "wb") as f:
        f.write(f"{n} {d}\n".encode())
        for w, vec in zip(words, vectors):
            f.write(w.encode("utf-8") + b" ")
            f.write(vec.tobytes())
            f.write(b"\n")


def load_google_binary(path: str | Path) -> tuple[list[str], np.ndarray]:
    words, rows = [], []
    with open(path, "rb") as f:
        header = f.readline().decode()
        n, d = (int(x) for x in header.split())
        for _ in range(n):
            w = bytearray()
            while True:
                c = f.read(1)
                if c == b" " or c == b"":
                    break
                if c != b"\n":
                    w.extend(c)
            vec = np.frombuffer(f.read(4 * d), dtype=np.float32)
            rows.append(vec)
            words.append(w.decode("utf-8"))
            f.read(1)  # trailing newline
    return words, np.stack(rows)


def save_word2vec(model, path: str | Path, binary: bool = False) -> None:
    words = model.vocab.words()
    # embeddings (not syn0): trims shard padding on ShardedWord2Vec so the
    # header row count matches the records written
    vectors = (model.embeddings if hasattr(model, "embeddings")
               else model.syn0.detach().cpu().numpy())
    (save_google_binary if binary else save_txt)(words, np.asarray(vectors), path)


def load_into_word2vec(path: str | Path, binary: bool = False, *,
                       device=None):
    """Rebuild a queryable Word2Vec (its table on ``device``, default
    CUDA) from a serialized file."""
    import torch

    from .vocab import VocabCache
    from .word2vec import Word2Vec

    words, vectors = (load_google_binary if binary else load_txt)(path)
    model = Word2Vec(layer_size=vectors.shape[1], device=device)
    cache = VocabCache()
    for i, w in enumerate(words):
        cache.add(w, by=float(len(words) - i))  # preserve order on finalize
    cache.finalize_indices()
    model.vocab = cache
    model.syn0 = torch.as_tensor(vectors, device=model.device)
    return model
