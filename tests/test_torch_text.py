"""The port's text pipeline (``deeplearning4j_tpu_torch.text``) on the CPU.

First every test of the JAX package's ``tests/test_text.py`` and
``tests/test_lm_dataset.py``, against the port.  Then parity with the
reference on shared inputs: vocab and Huffman codes equal; with both
packages on the same native pair generator and seed, the skip-gram pairs
and the permutation are equal, so a Word2Vec HS fit's tables agree
within 1e-5 after one iteration; one negative-sampling step on the same
targets within 1e-6 (the negatives' draws cannot match JAX's stream);
GloVe's loss curve and embeddings within 1e-5 over 3 iterations;
ParagraphVectors (HS) within 1e-5; the serializer's files cross both
ways; the vectorizers' matrices and the LM batches are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import text as J
from deeplearning4j_tpu.text import glove as JG
from deeplearning4j_tpu.text import serializer as JSer
from deeplearning4j_tpu.text import word2vec as JW
from deeplearning4j_tpu_torch import text as T
from deeplearning4j_tpu_torch.native import runtime as TN
from deeplearning4j_tpu_torch.text import glove as TG
from deeplearning4j_tpu_torch.text import serializer as TSer
from deeplearning4j_tpu_torch.text import word2vec as TW
from deeplearning4j_tpu_torch.text.tokenization import (
    CommonPreprocessor,
    DefaultTokenizer,
    NGramTokenizer,
)

CPU = "cpu"

# A tiny corpus with two clear topic clusters (fruit vs vehicles).
CORPUS = [
    "the apple is a sweet fruit",
    "banana is a yellow fruit and the banana is sweet",
    "orange fruit is sweet and orange is juicy",
    "apple and banana and orange are fruit",
    "fruit salad has apple banana orange",
    "the car drives on the road",
    "a truck is a big car on the road",
    "the bus drives people on the road",
    "car truck and bus are vehicles on the road",
    "vehicles like car and bus drive fast",
] * 8

SENTS = [
    "the quick brown fox jumps over the lazy dog",
    "the lazy dog sleeps while the quick fox runs",
    "a quick fox and a lazy dog meet the brown fox",
] * 8


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# --------------------------------------------------------------------------- tests/test_text.py

def test_tokenizer_and_preprocessors():
    t = DefaultTokenizer("Hello, World! 42 foo-bar")
    assert t.get_tokens() == ["Hello,", "World!", "42", "foo-bar"]
    t2 = DefaultTokenizer("Hello, World!", CommonPreprocessor())
    assert t2.get_tokens() == ["hello", "world"]
    ng = NGramTokenizer("a b c", n=2)
    assert "a b" in ng.get_tokens() and "b c" in ng.get_tokens()


def test_sentence_iterators(tmp_path):
    it = T.CollectionSentenceIterator(["s one", "s two"])
    assert list(it) == ["s one", "s two"]
    it.pre_processor = str.upper
    assert list(it) == ["S ONE", "S TWO"]
    p = tmp_path / "corpus.txt"
    p.write_text("line one\n\nline two\n")
    assert list(T.LineSentenceIterator(p)) == ["line one", "line two"]
    la = T.LabelAwareListSentenceIterator(["a", "b"], ["L0", "L1"])
    la.next_sentence()
    assert la.current_label() == "L0"
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "a.txt").write_text("x y\n\nz\n")
    assert list(T.FileSentenceIterator(tmp_path / "d")) == list(
        J.FileSentenceIterator(tmp_path / "d")) == ["x y", "z"]


def test_vocab_build_and_prune():
    cache = T.build_vocab(CORPUS, T.DefaultTokenizerFactory(CommonPreprocessor()),
                          min_word_frequency=5)
    assert "fruit" in cache and "car" in cache
    assert cache.index_of("nonexistent") == -1
    counts = cache.counts_array()
    assert counts[0] == counts.max()


def test_native_vocab_matches_python():
    tf = T.DefaultTokenizerFactory(CommonPreprocessor())
    fast = T.build_vocab(CORPUS, tf, min_word_frequency=1, use_native=True)
    slow = T.build_vocab(CORPUS, tf, min_word_frequency=1, use_native=False)
    assert set(fast.words()) == set(slow.words())
    for w in slow.words():
        assert fast.count_of(w) == slow.count_of(w), w


def test_huffman_codes():
    cache = T.build_vocab(CORPUS, T.DefaultTokenizerFactory(CommonPreprocessor()))
    h = T.Huffman(cache)
    h.build()
    total = sum(2.0 ** -len(cache.word_for(w).codes) for w in cache.words())
    assert abs(total - 1.0) < 1e-9
    ws = cache.words()
    assert len(cache.word_for(ws[0]).codes) <= len(cache.word_for(ws[-1]).codes)
    codes, points, lengths = h.code_arrays()
    assert codes.shape == points.shape
    assert lengths.max() == h.max_code_length


def test_word2vec_hs_learns_topics():
    model = T.Word2Vec(CORPUS, layer_size=32, window=3, iterations=8,
                       min_word_frequency=3, seed=7, device=CPU)
    model.fit()
    assert model.has_word("apple") and model.has_word("car")
    fruit_sim = model.similarity("apple", "banana")
    cross_sim = model.similarity("apple", "road")
    assert fruit_sim > cross_sim, (fruit_sim, cross_sim)
    assert model.get_word_vector("apple").shape == (32,)
    near = model.words_nearest("car", n=5)
    assert len(near) == 5 and "car" not in near


def test_word2vec_negative_sampling():
    model = T.Word2Vec(CORPUS, layer_size=32, window=3, iterations=8,
                       min_word_frequency=3, negative=5,
                       use_hierarchic_softmax=False, seed=7, device=CPU)
    model.fit()
    assert model.similarity("banana", "orange") > model.similarity("banana", "bus")


def test_word2vec_subsampling_runs():
    model = T.Word2Vec(CORPUS, layer_size=16, window=2, iterations=2,
                       sample=1e-3, seed=3, device=CPU)
    model.fit()
    assert np.all(np.isfinite(_np(model.syn0)))


def test_serializer_roundtrips(tmp_path):
    words = ["alpha", "beta", "gamma"]
    vecs = np.random.default_rng(0).random((3, 8)).astype(np.float32)
    TSer.save_txt(words, vecs, tmp_path / "v.txt")
    w2, v2 = TSer.load_txt(tmp_path / "v.txt")
    assert w2 == words
    np.testing.assert_allclose(v2, vecs, rtol=1e-4)
    TSer.save_google_binary(words, vecs, tmp_path / "v.bin")
    w3, v3 = TSer.load_google_binary(tmp_path / "v.bin")
    assert w3 == words
    np.testing.assert_allclose(v3, vecs)


def test_word2vec_save_load_query(tmp_path):
    model = T.Word2Vec(CORPUS, layer_size=16, iterations=2,
                       min_word_frequency=3, device=CPU)
    model.fit()
    TSer.save_word2vec(model, tmp_path / "w2v.bin", binary=True)
    loaded = TSer.load_into_word2vec(tmp_path / "w2v.bin", binary=True,
                                     device=CPU)
    np.testing.assert_allclose(loaded.get_word_vector("fruit"),
                               model.get_word_vector("fruit"), rtol=1e-5)


def test_glove_learns_topics():
    model = T.Glove(CORPUS, layer_size=24, window=5, iterations=30,
                    min_word_frequency=3, seed=5, device=CPU)
    model.fit()
    assert model.losses[-1] < model.losses[0]
    assert model.similarity("apple", "banana") > model.similarity("apple", "road")
    assert "apple" not in model.words_nearest("apple", n=3)


def test_paragraph_vectors():
    labels = [f"DOC_{i}" for i in range(len(CORPUS))]
    model = T.ParagraphVectors(CORPUS, labels, layer_size=24, window=3,
                               iterations=6, min_word_frequency=3, seed=11,
                               device=CPU)
    model.fit()
    assert model.doc_similarity("DOC_0", "DOC_1") > model.doc_similarity("DOC_0", "DOC_5")
    vec = model.infer_vector("sweet apple banana fruit")
    assert vec.shape == (24,) and np.all(np.isfinite(vec))
    assert len(model.docs_nearest("DOC_0", n=3)) == 3


def test_bow_and_tfidf():
    docs = ["apple banana apple", "car road car car", "apple car"]
    bow = T.BagOfWordsVectorizer()
    x = bow.fit_transform(docs)
    assert x.shape == (3, len(bow.vocab))
    assert x[0, bow.vocab.index_of("apple")] == 2.0
    tfidf = T.TfidfVectorizer()
    xt = tfidf.fit_transform(docs)
    assert xt.shape == x.shape
    assert np.all(np.isfinite(xt))
    ds = bow.vectorize(docs, [0, 1, 0])
    assert ds.num_outcomes() == 2


def test_native_skipgram_pairs_match_python_counts():
    assert TN.lib() is not None
    sents = [np.array([0, 1, 2, 3, 4], np.int32), np.array([5, 6, 7], np.int32)]
    centers, contexts = TN.skipgram_pairs(sents, window=2, seed=123)
    assert centers.shape == contexts.shape and centers.size > 0
    first = set(range(5))
    for c, x in zip(centers.tolist(), contexts.tolist()):
        assert (c in first) == (x in first)


def test_native_cooccurrence_matches_python(monkeypatch):
    """GloVe's co-occurrences through the native path equal the Python
    fallback's window-weighted counts."""
    vocab = T.build_vocab(CORPUS, T.DefaultTokenizerFactory(CommonPreprocessor()))
    tf = T.DefaultTokenizerFactory(CommonPreprocessor())
    fast = TG.CoOccurrences(vocab, tf, window=4).fit(CORPUS[:10])
    monkeypatch.setattr(TN, "cooccurrence", lambda *a: None)
    slow = TG.CoOccurrences(vocab, tf, window=4).fit(CORPUS[:10])
    assert fast._arrays is not None and slow._arrays is None
    got = {(int(r), int(c)): float(v) for r, c, v in zip(*fast.arrays())}
    want = {(int(r), int(c)): float(v) for r, c, v in zip(*slow.arrays())}
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-5


# --------------------------------------------------------------------------- tests/test_lm_dataset.py

def test_corpus_packs_and_decodes():
    corpus = T.LMCorpus(SENTS)
    toks = corpus.decode(corpus.ids)
    assert toks.count("<eos>") == len(SENTS)
    first = toks[:toks.index("<eos>")]
    assert first == SENTS[0].split()
    assert corpus.vocab.word_at(0) == "the"
    assert corpus.vocab_size == len(corpus.vocab) + 2


def test_unk_and_min_frequency():
    corpus = T.LMCorpus(SENTS, min_word_frequency=9)
    kept = set(corpus.vocab.words())
    assert "the" in kept and "sleeps" not in kept
    assert [corpus.vocab.index_of(w) for w in ("sleeps",)] == [-1]
    assert (corpus.ids == corpus.unk_id).sum() > 0


def test_batches_shift_property_and_epochs():
    corpus = T.LMCorpus(SENTS)
    it = T.LMTokenBatchIterator(corpus, batch=4, seq=8, seed=7, device=CPU)
    tokens, targets = it.next()
    assert tokens.shape == (4, 8) and targets.shape == (4, 8)
    assert tokens.dtype == torch.int32 and tokens.device.type == "cpu"
    assert torch.equal(tokens[:, 1:], targets[:, :-1])
    it2 = T.LMTokenBatchIterator(corpus, batch=4, seq=8, seed=7, device=CPU)
    e0 = [it2.next()[0] for _ in range(it2.batches_per_epoch)]
    e1 = [it2.next()[0] for _ in range(it2.batches_per_epoch)]
    assert not all(torch.equal(a, b) for a, b in zip(e0, e1))


def test_cursor_resume_is_deterministic():
    corpus = T.LMCorpus(SENTS)
    it = T.LMTokenBatchIterator(corpus, batch=2, seq=8, seed=3, device=CPU)
    seq = [it.next() for _ in range(5)]
    it2 = T.LMTokenBatchIterator(corpus, batch=2, seq=8, seed=3, device=CPU)
    it2.set_cursor(3)
    a, b = it2.next()
    assert torch.equal(a, seq[3][0]) and torch.equal(b, seq[3][1])
    assert it.cursor == 5


def test_too_small_corpus_rejected():
    with pytest.raises(ValueError, match="fewer than one batch"):
        T.LMTokenBatchIterator(T.LMCorpus(SENTS[:1]), batch=64, seq=128,
                               device=CPU)


def test_flagship_trains_on_packed_text():
    """tokenize -> pack -> batches -> the port's TransformerLM train steps
    reduce loss on a repetitive corpus."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.optimize import transforms as TT

    corpus = T.LMCorpus(SENTS)
    it = T.LMTokenBatchIterator(corpus, batch=4, seq=8, seed=0, device=CPU)
    cfg = TransformerConfig(
        vocab_size=corpus.vocab_size, d_model=32, n_heads=4, n_layers=2,
        d_ff=64, max_len=8, causal=True, dtype=torch.float32, remat=False)
    model = TransformerLM(cfg, device=CPU)
    tx = TT.adamw(0.01)
    params = model.init(torch.Generator().manual_seed(0))
    opt = model.init_opt(params, tx)
    step = model.build_train_step(tx)
    losses = []
    for tokens, targets in it.epoch_batches():
        for _ in range(6):
            params, opt, loss = step(params, opt, tokens, targets)
            losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


# --------------------------------------------------------------------------- parity with the reference

def _tf_pair():
    return (T.DefaultTokenizerFactory(CommonPreprocessor()),
            J.DefaultTokenizerFactory(J.tokenization.CommonPreprocessor()))


def test_vocab_and_huffman_equal_the_reference():
    tf, jtf = _tf_pair()
    t = T.build_vocab(CORPUS, tf, min_word_frequency=3)
    j = J.build_vocab(CORPUS, jtf, min_word_frequency=3)
    assert t.words() == j.words() and t.total_word_count == j.total_word_count
    np.testing.assert_array_equal(t.counts_array(), j.counts_array())
    th, jh = T.Huffman(t), J.Huffman(j)
    th.build()
    jh.build()
    for w in t.words():
        assert t.word_for(w).codes == j.word_for(w).codes, w
        assert t.word_for(w).points == j.word_for(w).points, w
    for a, b in zip(th.code_arrays(), jh.code_arrays()):
        np.testing.assert_array_equal(a, b)


def _w2v_pair(**kw):
    kw = dict(dict(layer_size=32, window=3, iterations=1, min_word_frequency=3,
                   seed=7), **kw)
    return T.Word2Vec(CORPUS, device=CPU, **kw), J.Word2Vec(CORPUS, **kw)


def test_word2vec_pairs_and_permutation_equal_the_reference():
    t, j = _w2v_pair(sample=1e-3)
    for m in (t, j):
        m.build_vocab()
    rt, rj = np.random.default_rng(7), np.random.default_rng(7)
    st, sj = t._sentence_indices(rt), j._sentence_indices(rj)
    assert len(st) == len(sj)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, b)
    ct, xt = t._pairs(st, rt)
    cj, xj = j._pairs(sj, rj)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(rt.permutation(ct.shape[0]),
                                  rj.permutation(cj.shape[0]))


@pytest.mark.parametrize("iterations", [1, 2])
def test_word2vec_hs_fit_equals_the_reference(iterations):
    """Same vocab, init, pairs, permutation and alpha schedule: the HS
    tables after the fit within 1e-5 (batches of 256 so a fit is many
    steps)."""
    t, j = _w2v_pair(iterations=iterations, batch_size=256)
    t.fit()
    j.fit()
    np.testing.assert_allclose(_np(t.syn0), np.asarray(j.syn0), atol=1e-5)
    np.testing.assert_allclose(_np(t.syn1), np.asarray(j.syn1), atol=1e-5)
    assert np.abs(_np(t.syn1)).max() > 1e-3        # the fit moved the tables


def test_ns_step_on_the_same_targets_equals_the_reference():
    rng = np.random.default_rng(0)
    n, d, B, K = 40, 16, 64, 5
    syn0 = (rng.random((n, d), np.float32) - 0.5) / d
    syn1neg = rng.standard_normal((n, d)).astype(np.float32) * 0.1
    centers = rng.integers(0, n, B).astype(np.int32)
    targets = rng.integers(0, n, (B, 1 + K)).astype(np.int32)
    labels = np.zeros((B, 1 + K), np.float32)
    labels[:, 0] = 1.0
    a0, a1 = JW._ns_step(jnp.asarray(syn0), jnp.asarray(syn1neg),
                         jnp.asarray(centers), jnp.asarray(targets),
                         jnp.asarray(labels), jnp.float32(0.025))
    b0, b1 = TW._ns_step(torch.tensor(syn0), torch.tensor(syn1neg),
                         torch.tensor(centers).long(),
                         torch.tensor(targets).long(), torch.tensor(labels),
                         0.025)
    np.testing.assert_allclose(_np(b0), np.asarray(a0), atol=1e-6)
    np.testing.assert_allclose(_np(b1), np.asarray(a1), atol=1e-6)
    assert np.abs(_np(b1) - syn1neg).max() > 1e-4


def test_hs_step_on_the_same_paths_equals_the_reference():
    rng = np.random.default_rng(1)
    n, d, B, L = 30, 8, 50, 6
    syn0 = (rng.random((n, d), np.float32) - 0.5) / d
    syn1 = rng.standard_normal((n - 1, d)).astype(np.float32) * 0.1
    centers = rng.integers(0, n, B).astype(np.int32)
    points = rng.integers(0, n - 1, (B, L)).astype(np.int32)
    codes = rng.integers(0, 2, (B, L)).astype(np.float32)
    mask = (rng.random((B, L)) < 0.8).astype(np.float32)
    a0, a1 = JW._hs_step(jnp.asarray(syn0), jnp.asarray(syn1),
                         jnp.asarray(centers), jnp.asarray(points),
                         jnp.asarray(codes), jnp.asarray(mask),
                         jnp.float32(0.025))
    b0, b1 = TW._hs_step(torch.tensor(syn0), torch.tensor(syn1),
                         torch.tensor(centers).long(),
                         torch.tensor(points).long(), torch.tensor(codes),
                         torch.tensor(mask), 0.025)
    np.testing.assert_allclose(_np(b0), np.asarray(a0), atol=1e-6)
    np.testing.assert_allclose(_np(b1), np.asarray(a1), atol=1e-6)


def test_negative_draws_follow_the_unigram_table():
    """The port's negatives (torch.multinomial on a seeded generator) are
    reproducible and follow the 0.75-power unigram distribution."""
    t, _ = _w2v_pair(negative=5, use_hierarchic_softmax=False)
    t.build_vocab()
    t.reset_weights()
    draw = [TW._sample_negatives(torch.Generator().manual_seed(3),
                                 t._unigram, (4000, 5)) for _ in range(2)]
    assert torch.equal(draw[0], draw[1]) and draw[0].shape == (4000, 5)
    freq = np.bincount(draw[0].flatten().numpy(),
                       minlength=len(t.vocab)) / draw[0].numel()
    np.testing.assert_allclose(freq, _np(t._unigram), atol=0.01)


def test_glove_fit_equals_the_reference():
    kw = dict(layer_size=16, window=5, iterations=3, min_word_frequency=3,
              seed=5, batch_size=64, resolve_every=4)
    t = T.Glove(CORPUS, device=CPU, **kw).fit()
    j = J.Glove(CORPUS, **kw).fit()
    np.testing.assert_allclose(t.losses, j.losses, atol=1e-5)
    np.testing.assert_allclose(_np(t.syn0), np.asarray(j.syn0), atol=1e-5)
    for a, b in zip(t._tables, j._tables):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)
    assert t.losses[-1] < t.losses[0]


def test_glove_step_reads_the_accumulator_after_its_update():
    """A row that appears twice in a batch takes both squared gradients
    into its AdaGrad accumulator before either update is scaled."""
    w = torch.tensor([[0.5, -0.2], [0.1, 0.3]])
    tabs = [w.clone(), w.clone(), torch.zeros(2), torch.zeros(2),
            torch.zeros(2, 2), torch.zeros(2, 2), torch.zeros(2),
            torch.zeros(2)]
    jt = [jnp.asarray(_np(x).copy()) for x in tabs]   # before the in-place step
    rows = torch.tensor([0, 0]); cols = torch.tensor([1, 0])
    logx = torch.tensor([0.3, -0.1]); fx = torch.tensor([1.0, 0.5])
    lt = TG._glove_step(*tabs, rows, cols, logx, fx, 0.05)
    *jt, lj = JG._glove_step(*jt, jnp.asarray(_np(rows)), jnp.asarray(_np(cols)),
                             jnp.asarray(_np(logx)), jnp.asarray(_np(fx)),
                             jnp.float32(0.05))
    for a, b in zip(tabs, jt):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-7)
    assert abs(float(lt) - float(lj)) < 1e-7


def test_paragraph_vectors_hs_equal_the_reference():
    labels = [f"DOC_{i}" for i in range(len(CORPUS))]
    kw = dict(layer_size=16, window=3, iterations=2, min_word_frequency=3,
              seed=11, batch_size=256)
    t = T.ParagraphVectors(CORPUS, labels, device=CPU, **kw).fit()
    j = J.ParagraphVectors(CORPUS, labels, **kw).fit()
    np.testing.assert_allclose(_np(t.syn0), np.asarray(j.syn0), atol=1e-5)
    np.testing.assert_allclose(_np(t.doc_vectors), np.asarray(j.doc_vectors),
                               atol=1e-5)
    np.testing.assert_allclose(_np(t.syn1), np.asarray(j.syn1), atol=1e-5)
    np.testing.assert_allclose(t.infer_vector("sweet apple banana fruit"),
                               j.infer_vector("sweet apple banana fruit"),
                               atol=1e-5)


@pytest.mark.parametrize("binary", [False, True])
def test_serializer_files_cross_both_ways(tmp_path, binary):
    words = ["alpha", "beta", "gamma", "delta"]
    vecs = np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
    save = "save_google_binary" if binary else "save_txt"
    load = "load_google_binary" if binary else "load_txt"
    getattr(TSer, save)(words, vecs, tmp_path / "t")
    getattr(JSer, save)(words, vecs, tmp_path / "j")
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    for mod, path in ((TSer, "j"), (JSer, "t")):
        w, v = getattr(mod, load)(tmp_path / path)
        assert w == words
        np.testing.assert_array_equal(v, getattr(JSer, load)(tmp_path / "j")[1])
    # a port model saved, loaded by the reference, and back
    m = T.Word2Vec(CORPUS, layer_size=8, min_word_frequency=3, device=CPU)
    m.fit()
    TSer.save_word2vec(m, tmp_path / "m", binary=binary)
    back = JSer.load_into_word2vec(tmp_path / "m", binary=binary)
    JSer.save_word2vec(back, tmp_path / "r", binary=binary)
    again = TSer.load_into_word2vec(tmp_path / "r", binary=binary, device=CPU)
    assert again.vocab.words() == back.vocab.words() == m.vocab.words()
    # binary is exact; text keeps 6 significant digits ("%.6g")
    rtol = 0 if binary else 5e-6
    np.testing.assert_allclose(np.asarray(back.get_word_vector("fruit")),
                               m.get_word_vector("fruit"), rtol=rtol, atol=0)
    np.testing.assert_allclose(again.embeddings, m.embeddings, rtol=rtol,
                               atol=0)


def test_glove_saves_through_the_serializer(tmp_path):
    g = T.Glove(CORPUS, layer_size=8, iterations=2, min_word_frequency=3,
                device=CPU).fit()
    TSer.save_word2vec(g, tmp_path / "g.txt")
    words, vecs = JSer.load_txt(tmp_path / "g.txt")
    assert words == g.vocab.words()
    np.testing.assert_allclose(vecs, _np(g.syn0), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_vectorizers_equal_the_reference(cls):
    docs = CORPUS[:10] + ["apple car road fruit"]
    t, j = getattr(T, cls)(), getattr(J, cls)()
    np.testing.assert_array_equal(t.fit_transform(docs), j.fit_transform(docs))
    ds_t = getattr(T, cls)(binary=True).vectorize(docs, [0] * 5 + [1] * 6)
    ds_j = getattr(J, cls)(binary=True).vectorize(docs, [0] * 5 + [1] * 6)
    np.testing.assert_array_equal(ds_t.features, ds_j.features)
    np.testing.assert_array_equal(ds_t.labels, ds_j.labels)


@pytest.mark.parametrize("shuffle", [True, False])
def test_lm_batches_equal_the_reference(shuffle):
    t = T.LMCorpus(SENTS, min_word_frequency=2)
    j = J.LMCorpus(SENTS, min_word_frequency=2)
    np.testing.assert_array_equal(t.ids, j.ids)
    assert t.decode(t.ids[:20]) == j.decode(j.ids[:20])
    ti = T.LMTokenBatchIterator(t, batch=3, seq=7, seed=4, shuffle=shuffle,
                                device=CPU)
    ji = J.LMTokenBatchIterator(j, batch=3, seq=7, seed=4, shuffle=shuffle)
    for _ in range(2 * ji.batches_per_epoch + 1):
        (a, b), (c, d) = ti.next(), ji.next()
        np.testing.assert_array_equal(_np(a), c)
        np.testing.assert_array_equal(_np(b), d)
    assert ti.cursor == ji.cursor


def test_text_exports_the_reference_names():
    assert T.__all__ == J.__all__
    for name in J.__all__:
        assert hasattr(T, name), name


def test_models_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: T.Word2Vec(CORPUS), lambda: T.Glove(CORPUS),
                 lambda: T.ParagraphVectors(CORPUS),
                 lambda: T.LMTokenBatchIterator(T.LMCorpus(SENTS), 2, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def _skewed_corpus(n_tokens=40000, vocab=1000, topics=10, sent_len=20):
    """Sentences of one topic each: a fifth of the words shared (Zipf over
    the corpus), the rest per topic (Zipf within it), 60% topic words."""
    rng = np.random.default_rng(0)
    n_shared = vocab // 5
    per = (vocab - n_shared) // topics

    def zipf(n):
        p = 1.0 / np.arange(1, n + 1)
        return p / p.sum()

    ns = n_tokens // sent_len
    topic = rng.integers(0, topics, ns)
    own = rng.random((ns, sent_len)) < 0.6
    words = np.where(
        own, n_shared + topic[:, None] * per
        + rng.choice(per, (ns, sent_len), p=zipf(per)),
        rng.choice(n_shared, (ns, sent_len), p=zipf(n_shared)))
    return [" ".join(f"w{i}" for i in row) for row in words]


@pytest.mark.parametrize("sample", [0.0, 1e-3])
def test_skewed_corpus_diverges_without_subsampling_in_both(sample):
    """The batched update sums every pair of a batch: on a Zipfian corpus
    the most frequent word's summed updates blow up in both packages
    without subsampling, and stay finite with word2vec's 1e-3 (the
    setting ``chip_smoke.py::run_text`` uses)."""
    corpus = _skewed_corpus()
    kw = dict(seed=1, sample=sample, iterations=2)
    t = T.Word2Vec(corpus, device=CPU, **kw).fit()
    j = J.Word2Vec(corpus, **kw).fit()
    finite = bool(torch.isfinite(t.syn0).all())
    assert finite == bool(np.isfinite(np.asarray(j.syn0)).all())
    assert finite == (sample > 0)
