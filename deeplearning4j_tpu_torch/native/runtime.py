"""ctypes bindings for the native host runtime, with silent fallbacks.

Port of ``deeplearning4j_tpu/native/runtime.py``: the same six C entry
points (``drt_count_tokens``, ``drt_free``, ``drt_skipgram_pairs``,
``drt_cooccurrence``, ``drt_parse_svmlight``, ``drt_parse_csv_floats``)
and the same results.  ``lib()`` returns the loaded shared library or
None; call sites check and fall back to pure Python.  The library is
built on demand at most once per process (a cheap g++ compile into the
port's build directory, cached on disk, safe against other processes
building it at the same moment: ``build.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import build as _build

_LIB: ctypes.CDLL | None = None
_TRIED = False


def lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _build.lib_path()
    if _build.stale(path):
        if _build.build(verbose=False, force=False) is None \
                and not path.exists():
            return None
    try:
        l = ctypes.CDLL(str(path))
    except OSError:
        return None
    l.drt_count_tokens.restype = ctypes.c_void_p
    l.drt_count_tokens.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int64)]
    l.drt_free.argtypes = [ctypes.c_void_p]
    l.drt_skipgram_pairs.restype = ctypes.c_int64
    l.drt_skipgram_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64]
    l.drt_parse_csv_floats.restype = ctypes.c_int64
    l.drt_parse_csv_floats.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    l.drt_cooccurrence.restype = ctypes.c_void_p
    l.drt_cooccurrence.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]
    l.drt_parse_svmlight.restype = ctypes.c_int64
    l.drt_parse_svmlight.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    _LIB = l
    return _LIB


def count_tokens(sentences, tokenizer_factory) -> dict[str, float] | None:
    """Native tokenize+count.  Only valid for the default tokenizer family
    (lowercase + strip punctuation + whitespace split); returns None for
    custom tokenizers so the caller uses the Python path."""
    from ..text.tokenization import (CommonPreprocessor, DefaultTokenizer,
                                     DefaultTokenizerFactory)
    if not isinstance(tokenizer_factory, DefaultTokenizerFactory):
        return None
    if not isinstance(tokenizer_factory.pre, (CommonPreprocessor, type(None))):
        return None
    if tokenizer_factory.pre is None:
        return None  # native path lowercases; plain tokenizer must not
    l = lib()
    if l is None:
        return None
    joined = "\n".join(sentences)
    if not joined.isascii():
        # the C fast path implements Python's \w semantics for ASCII only;
        # Unicode corpora take the exact Python tokenizer
        return None
    text = joined.encode("utf-8")
    out_len = ctypes.c_int64(0)
    ptr = l.drt_count_tokens(text, len(text), ctypes.byref(out_len))
    if not ptr:
        return None
    try:
        raw = ctypes.string_at(ptr, out_len.value).decode("utf-8")
    finally:
        l.drt_free(ptr)
    counts: dict[str, float] = {}
    for line in raw.splitlines():
        if "\t" in line:
            w, c = line.rsplit("\t", 1)
            counts[w] = float(c)
    return counts


def skipgram_pairs(sentence_indices, window: int, seed: int):
    """Native (center, context) generation; None -> use the Python path."""
    l = lib()
    if l is None or not sentence_indices:
        return None
    tokens = np.concatenate(sentence_indices).astype(np.int32)
    offsets = np.zeros(len(sentence_indices) + 1, np.int64)
    np.cumsum([len(s) for s in sentence_indices], out=offsets[1:])
    tok_p = tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    off_p = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    n = l.drt_skipgram_pairs(tok_p, off_p, len(sentence_indices), window,
                             seed, None, None, 0)
    if n <= 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32)) if n == 0 else None
    centers = np.empty(n, np.int32)
    contexts = np.empty(n, np.int32)
    wrote = l.drt_skipgram_pairs(
        tok_p, off_p, len(sentence_indices), window, seed,
        centers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        contexts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
    if wrote != n:
        return None
    return centers, contexts


def cooccurrence(sentence_indices, window: int):
    """Native window-weighted co-occurrence accumulation (the GloVe host
    hot loop).  Returns (rows, cols, vals) arrays or None -> Python path."""
    l = lib()
    if l is None or not sentence_indices:
        return None
    tokens = np.concatenate(sentence_indices).astype(np.int32)
    offsets = np.zeros(len(sentence_indices) + 1, np.int64)
    np.cumsum([len(s) for s in sentence_indices], out=offsets[1:])
    out_bytes = ctypes.c_int64(0)
    ptr = l.drt_cooccurrence(
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(sentence_indices), window, ctypes.byref(out_bytes))
    if not ptr:
        return None
    try:
        raw = ctypes.string_at(ptr, out_bytes.value)
    finally:
        l.drt_free(ptr)
    n = int(np.frombuffer(raw[:8], np.int64)[0])
    rec = np.frombuffer(raw[8:], np.uint8).reshape(n, 12)
    rows = rec[:, 0:4].copy().view(np.int32)[:, 0]
    cols = rec[:, 4:8].copy().view(np.int32)[:, 0]
    vals = rec[:, 8:12].copy().view(np.float32)[:, 0]
    return rows, cols, vals


def parse_csv_floats(text: str, n_cols: int) -> np.ndarray | None:
    l = lib()
    if l is None:
        return None
    data = text.encode("utf-8")
    max_rows = text.count("\n") + 2
    out = np.empty((max_rows, n_cols), np.float32)
    rows = l.drt_parse_csv_floats(
        data, len(data), n_cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_rows)
    if rows < 0:
        return None
    return out[:rows]


def parse_svmlight(data: bytes, num_features: int):
    """Native svmlight parse of a text buffer -> (dense features, float
    labels, n_skipped_out_of_range); None -> use the Python parser (lib
    missing or malformed input needing Python's exact errors)."""
    l = lib()
    if l is None:
        return None
    max_rows = data.count(b"\n") + 2
    feats = np.zeros((max_rows, num_features), np.float32)   # sparse rows
    labels = np.empty(max_rows, np.float32)
    skipped = ctypes.c_int64(0)
    rows = l.drt_parse_svmlight(
        data, len(data), num_features,
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_rows, ctypes.byref(skipped))
    if rows < 0:
        return None
    return feats[:rows], labels[:rows], int(skipped.value)
