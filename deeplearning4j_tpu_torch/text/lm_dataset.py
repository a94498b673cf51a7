"""Corpus -> (tokens, targets) batch pipeline for language-model training.

The connective tissue between the L8 text stack (tokenization/vocab,
reference ``text/**``) and the flagship ``TransformerLM``: the reference
era fed sequence models through ``MovingWindowBaseDataSetIterator``-style
fixed windows (``datasets/iterator/.../MovingWindowBaseDataSetIterator.java``,
``Windows.java:17``); a TPU LM wants the GPT-style alternative — tokenize
the whole corpus ONCE into one contiguous id array (documents joined by an
``<eos>`` separator), then slice dense ``(B, T)`` blocks with shifted
targets.  Dense packing keeps every MXU step full (no padding waste),
shapes are static for jit, and the block-order shuffle is stateless-keyed
so an epoch is reproducible and resumable from a cursor (composes with
``parallel.checkpoint`` and ``datasets.iterator.prefetch_to_device``).

Port of ``deeplearning4j_tpu/text/lm_dataset.py``: the corpus is packed
on the host as there (numpy ids, the same vocabulary), and the blocks go
to the iterator's device once; each batch is a pair of int32 tensors on
that device (default CUDA), sliced there in the JAX package's order.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .tokenization import DefaultTokenizerFactory
from .vocab import VocabCache

EOS = "<eos>"
UNK = "<unk>"


class LMCorpus:
    """Tokenized, packed corpus with a word <-> id vocabulary.

    ``vocab_size`` counts the two specials; ids: 0..n_words-1 are corpus
    words (frequency-sorted, the word2vec convention), then ``<eos>``,
    then ``<unk>``.
    """

    def __init__(self, sentences: Iterable[str], tokenizer_factory=None,
                 min_word_frequency: float = 1.0,
                 vocab: VocabCache | None = None):
        tf = tokenizer_factory or DefaultTokenizerFactory()
        sentences = [s for s in sentences if s and s.strip()]
        # tokenize ONCE; both the vocab count and the id pass read the same
        # token lists (tokenization dominates corpus-construction cost)
        tokenized = [tf.create(s).get_tokens() for s in sentences]
        if vocab is None:
            vocab = VocabCache()
            for toks in tokenized:
                for tok in toks:
                    vocab.add(tok)
            vocab.prune(min_word_frequency)
        self.vocab = vocab
        n = len(self.vocab)
        self.eos_id, self.unk_id = n, n + 1
        self.vocab_size = n + 2
        ids: list[int] = []
        for toks in tokenized:
            for tok in toks:
                i = self.vocab.index_of(tok)
                ids.append(i if i >= 0 else self.unk_id)
            ids.append(self.eos_id)
        self.ids = np.asarray(ids, np.int32)

    def decode(self, ids: Sequence[int]) -> list[str]:
        out = []
        for i in ids:
            i = int(i)
            if i == self.eos_id:
                out.append(EOS)
            elif i == self.unk_id or i < 0 or i >= len(self.vocab):
                out.append(UNK)
            else:
                out.append(self.vocab.word_at(i))
        return out


class LMTokenBatchIterator:
    """Epochs of dense ``(batch, seq)`` LM batches over an :class:`LMCorpus`.

    Each batch is ``(tokens, targets)`` with ``targets[i, t] ==
    tokens[i, t+1]`` (blocks are cut ``seq + 1`` wide so the shift never
    crosses a block edge).  Block order reshuffles per epoch from
    ``seed`` (stateless: epoch k's permutation is a pure function of
    ``seed + k``), and ``cursor``/``set_cursor`` expose resumable position
    in batches-since-epoch-0 for checkpoint integration.  Batches are
    int32 tensors on ``device`` (default CUDA).
    """

    def __init__(self, corpus: LMCorpus, batch: int, seq: int,
                 seed: int = 0, shuffle: bool = True, *, device=None):
        self.corpus, self.batch, self.seq = corpus, batch, seq
        self.seed, self.shuffle = seed, shuffle
        span = seq + 1
        n_blocks = len(corpus.ids) // span
        if n_blocks < batch:
            raise ValueError(
                f"corpus packs into {n_blocks} blocks of {span} tokens — "
                f"fewer than one batch of {batch}; shrink batch/seq or "
                "grow the corpus")
        self.device = resolve_device(device)
        self.blocks = torch.as_tensor(
            corpus.ids[:n_blocks * span].reshape(n_blocks, span),
            device=self.device)
        self.batches_per_epoch = n_blocks // batch
        self._cursor = 0          # global batch index across epochs
        self._order_cache: tuple[int, np.ndarray] | None = None

    # -- resumable position ----------------------------------------------
    @property
    def cursor(self) -> int:
        return self._cursor

    def set_cursor(self, cursor: int) -> None:
        self._cursor = int(cursor)

    def _order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.blocks))
        if self._order_cache is None or self._order_cache[0] != epoch:
            self._order_cache = (epoch, np.random.default_rng(
                self.seed + epoch).permutation(len(self.blocks)))
        return self._order_cache[1]

    def next(self) -> tuple[torch.Tensor, torch.Tensor]:
        epoch, k = divmod(self._cursor, self.batches_per_epoch)
        order = self._order(epoch)
        rows = order[k * self.batch:(k + 1) * self.batch]
        blk = self.blocks[torch.as_tensor(rows, device=self.device)]
        self._cursor += 1
        return blk[:, :-1], blk[:, 1:]

    def epoch_batches(self):
        """One epoch's worth of batches from the current cursor."""
        for _ in range(self.batches_per_epoch):
            yield self.next()

    def __iter__(self):
        while True:
            yield self.next()
