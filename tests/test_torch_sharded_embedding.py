"""The port's ep-sharded Word2Vec and GloVe against the JAX package, over
gloo CPU ranks.

The reference's ``tests/test_sharded_embedding.py`` fixtures (its corpus,
hyperparameters and checks) at ep=4 (one pool of four ranks for the
module, ``tests/torch_ranks.py``): the tables are row-split over ep, each
batch's rows shipped by a masked gather and a psum, and the deltas
scatter-added to the owned rows.  The sharded fit equals the port's
one-device fit (the reference's ``rtol=1e-4`` / ``atol=1e-5``), whose
hierarchical-softmax and GloVe fits equal the reference's one-device
fits (the same window: the batches, Huffman tree and permutations are the
same numpy draws).  Negative sampling draws from ``torch.multinomial``,
which cannot follow the JAX key's stream: with negatives the sharded fit
is held to the port's one-device fit only.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.text.glove import Glove as JGlove
from deeplearning4j_tpu.text.sharded_embedding import pad_rows as jpad_rows
from deeplearning4j_tpu.text.word2vec import Word2Vec as JWord2Vec
from deeplearning4j_tpu_torch.text.glove import Glove
from deeplearning4j_tpu_torch.text.sharded_embedding import pad_rows
from deeplearning4j_tpu_torch.text.word2vec import Word2Vec
from torch_ranks import RankPool

WORLD = 4
RTOL, ATOL = 1e-4, 1e-5

CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the rug",
    "a cat and a dog played",
    "the king ruled the land",
    "the queen ruled the kingdom",
    "a king and a queen reigned",
    "cats chase mice in the barn",
    "dogs chase cats in the yard",
] * 6


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_pad_rows():
    for n, k in ((10, 8), (16, 8), (1, 8), (0, 4), (10, 4)):
        assert pad_rows(n, k) == jpad_rows(n, k)
    assert pad_rows(10, 8) == 16 and pad_rows(0, 4) == 4


@pytest.mark.parametrize("negative,hs", [(0, True), (5, True), (5, False)])
def test_sharded_word2vec_matches_single_device(pool, negative, hs):
    """Row-split tables and psum row shipping == the one-device fit, for
    HS, HS+NS and NS-only; the query API agrees."""
    kw = dict(layer_size=16, window=3, iterations=2, seed=11,
              negative=negative, use_hierarchic_softmax=hs, batch_size=256)
    res = pool.run("ep_embedding", "w2v", CORPUS, kw)
    solo = Word2Vec(CORPUS, device="cpu", **kw).fit()
    for r in range(WORLD):
        _close(res[r]["emb"], solo.embeddings)
    n1 = solo.syn1.shape[0]
    _close(res[0]["syn1"][:n1], solo.syn1.numpy())
    assert res[0]["nearest"] == solo.words_nearest("cat", 3)
    if negative == 0:
        ref = JWord2Vec(CORPUS, **kw).fit()
        _close(res[0]["emb"], ref.embeddings)
        assert res[0]["nearest"] == ref.words_nearest("cat", 3)


def test_sharded_glove_matches_single_device(pool):
    kw = dict(layer_size=12, window=5, iterations=4, seed=5, batch_size=512)
    res = pool.run("ep_embedding", "glove", CORPUS, kw)
    solo = Glove(CORPUS, device="cpu", **kw).fit()
    ref = JGlove(CORPUS, **kw).fit()
    for r in range(WORLD):
        _close(res[r]["emb"], solo.syn0.numpy())
    _close(res[0]["emb"], np.asarray(ref.syn0))
    assert res[0]["nearest"] == solo.words_nearest("cat", 3) \
        == ref.words_nearest("cat", 3)


def test_sharded_word2vec_semantic_structure(pool):
    res = pool.run("ep_embedding", "w2v", CORPUS,
                   dict(layer_size=24, window=3, iterations=12, seed=3),
                   similarity=("king", "queen", "mat"))
    for r in range(WORLD):
        king_queen, king_mat = res[r]["similarity"]
        assert king_queen > king_mat
