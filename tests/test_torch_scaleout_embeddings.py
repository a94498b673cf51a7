"""The port's row-shipping Word2Vec over the scaleout SPI
(``text.scaleout_embeddings``) against the JAX package's, after
``tests/test_sharded_embedding.py``'s scaleout case.

- Three worker threads under ``HogWildWorkRouter`` converge to the same
  semantic structure as the reference's test holds (king~queen above
  king~mat, cat~dog above cat~kingdom), HS and NS, on the CPU.
- One worker under ``IterativeReduceWorkRouter``, HS and NS, from the
  reference's ``EmbeddingTables`` carried across as numpy: the job
  iterator draws the same negatives (one ``np.random.default_rng(seed)``
  stream), the performer the same skip-gram pairs, and every table ends
  within 1e-5 of the reference's (float32 steps summed in another order,
  over 48 sequential jobs).
- The deltas a worker ships are numpy rows, only those it touched.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.parallel.scaleout as jso
import deeplearning4j_tpu.text.scaleout_embeddings as jse
import deeplearning4j_tpu_torch.parallel.scaleout as tso
import deeplearning4j_tpu_torch.text.scaleout_embeddings as tse
from deeplearning4j_tpu.text.word2vec import Word2Vec as JWord2Vec
from deeplearning4j_tpu_torch.text.word2vec import Word2Vec
from torch_port_obs import port_obs  # noqa: F401  (autouse)

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
#: the port's tables after a one-worker run against the reference's
TOL_TABLES = 1e-5


def _tokenized(corpus, w2v):
    fac = w2v.tokenizer_factory
    out = []
    for s in corpus:
        toks = fac.create(s).get_tokens()
        idx = np.array([i for i in (w2v.vocab.index_of(t) for t in toks)
                        if i >= 0], np.int32)
        if idx.size >= 2:
            out.append(idx)
    return out


def _factory(se, negative, codes, points, lengths, **kw):
    hs = negative == 0

    def make(tr):
        return se.Word2VecPerformer(
            tr, window=3, negative=negative,
            codes=codes.astype(np.float32) if hs else None,
            points=points if hs else None,
            lengths=lengths if hs else None, **kw)
    return make


@pytest.mark.parametrize("negative", [0, 3])
def test_scaleout_word2vec_performer(negative):
    """Row-shipping distributed Word2Vec over the scaleout SPI
    (Word2VecPerformer.java:72-137 semantics): multi-worker training
    converges to the same semantic structure as local training."""
    base = Word2Vec(CORPUS, layer_size=24, window=3, negative=negative,
                    use_hierarchic_softmax=(negative == 0), seed=3,
                    device="cpu")
    base.build_vocab()
    base.reset_weights()
    tables = tse.EmbeddingTables.from_model(base)
    sents = _tokenized(CORPUS, base)

    tracker = tso.StateTracker()
    it = tse.Word2VecJobIterator(
        sents * 12, tables, window=3, chunk=6, negative=negative,
        alpha=0.05, iterations=1, tracker=tracker)
    codes, points, lengths = base.huffman.code_arrays()
    runner = tso.DistributedRunner(
        it, _factory(tse, negative, codes, points, lengths, device="cpu"),
        n_workers=3, router_cls=tso.HogWildWorkRouter, tracker=tracker)
    runner.router.aggregator_factory = lambda: tse.RowDeltaAggregator(tables)
    runner.run(max_wall_s=120.0)

    assert tracker.count(tse.WORDS_KEY) == sum(s.size for s in sents) * 12
    # read trained vectors through the model facade
    base.syn0 = torch.as_tensor(tables.syn0)
    assert base.similarity("king", "queen") > base.similarity("king", "mat")
    assert base.similarity("cat", "dog") > base.similarity("cat", "kingdom")


def _one_worker(so, se, tables, sents, negative, codes, points, lengths,
                **kw):
    tracker = so.StateTracker()
    it = se.Word2VecJobIterator(
        sents * 8, tables, window=3, chunk=6, negative=negative,
        alpha=0.05, iterations=1, tracker=tracker, seed=5)
    runner = so.DistributedRunner(
        it, _factory(se, negative, codes, points, lengths, **kw),
        n_workers=1, router_cls=so.IterativeReduceWorkRouter,
        tracker=tracker)
    runner.router.aggregator_factory = lambda: se.RowDeltaAggregator(tables)
    runner.run(max_wall_s=120.0)
    return tables, tracker.count(se.WORDS_KEY)


def _copy(tables, cls):
    return cls(**{k: (None if v is None else np.array(v, copy=True))
                  for k, v in vars(tables).items()})


@pytest.mark.parametrize("negative", [0, 3], ids=["hs", "ns"])
def test_one_worker_run_equals_the_reference(negative):
    ref = JWord2Vec(CORPUS, layer_size=16, window=3, negative=negative,
                    use_hierarchic_softmax=(negative == 0), seed=3)
    ref.build_vocab()
    ref.reset_weights()
    jt = jse.EmbeddingTables.from_model(ref)
    tt = _copy(jt, tse.EmbeddingTables)
    sents = _tokenized(CORPUS, ref)
    codes, points, lengths = ref.huffman.code_arrays()
    start = np.array(jt.syn0, copy=True)

    want, jwords = _one_worker(jso, jse, jt, sents, negative, codes, points,
                               lengths)
    got, twords = _one_worker(tso, tse, tt, sents, negative, codes, points,
                              lengths, device="cpu")
    assert twords == jwords > 0
    assert np.abs(got.syn0 - start).max() > 1e-3       # it trained
    for name in ("syn0", "syn1", "syn1neg"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None
            continue
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_TABLES,
                                   err_msg=name)


@pytest.mark.parametrize("negative", [0, 3], ids=["hs", "ns"])
def test_a_job_ships_numpy_deltas_of_the_touched_rows(negative):
    base = Word2Vec(CORPUS, layer_size=8, window=3, negative=negative,
                    use_hierarchic_softmax=(negative == 0), seed=1,
                    device="cpu")
    base.build_vocab()
    base.reset_weights()
    tables = tse.EmbeddingTables.from_model(base)
    sents = _tokenized(CORPUS, base)[:6]
    it = tse.Word2VecJobIterator(sents, tables, window=3, chunk=6,
                                 negative=negative, alpha=0.05)
    job = it.next("w0")
    codes, points, lengths = base.huffman.code_arrays()
    perf = _factory(tse, negative, codes, points, lengths,
                    device="cpu")(tso.StateTracker())
    perf.perform(job)
    r = job.result
    assert set(r.d0) == set(job.work.rows0)
    words = set(np.concatenate(sents).tolist())
    assert set(r.d0) == words
    assert set(r.d1) == set(job.work.rows1)
    assert set(r.d1neg) == set(job.work.rows1neg)
    for d in (r.d0, r.d1, r.d1neg):
        assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
                   for v in d.values())
    assert r.n_words == sum(s.size for s in sents)
    assert perf.tracker.count(tse.WORDS_KEY) == r.n_words


def test_performer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tse.Word2VecPerformer(tso.StateTracker())
