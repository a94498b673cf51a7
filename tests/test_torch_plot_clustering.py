"""The port's clustering and plotting (``deeplearning4j_tpu_torch.clustering``
and ``.plot``) on the CPU, against the JAX package on shared inputs.

k-means: one Lloyd sweep and whole fits give centroids within 1e-5 and
equal labels (the reference test's blobs and a wider random case), with
the ``kmeans.fit`` span and the ``kmeans.sweeps`` counter.  Exact t-SNE:
``_pairwise_sq_dists``, ``_tsne_grad`` (gradient and KL) and
``_input_probs`` within 1e-5 relative (on points about the origin),
``fit_transform`` over 20 iterations within 1e-4 of the embedding's
scale (at learning rates where the trajectory is stable: at the defaults
these small sets amplify rounding chaotically), and the reference tests'
separation and finiteness at their sizes.  Barnes-Hut t-SNE and
the KD, VP and quad trees give the reference's outputs exactly (host
numpy in both).  The renderers write the same files; the render server
serves ``/api/coords``, also from a port ``Word2Vec``.
"""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.clustering import kmeans as JK
from deeplearning4j_tpu import clustering as JC
from deeplearning4j_tpu import plot as JPL
from deeplearning4j_tpu.plot import tsne as JTS
from deeplearning4j_tpu_torch import clustering as TC
from deeplearning4j_tpu_torch import plot as TPL
from deeplearning4j_tpu_torch.clustering import kmeans as TK
from deeplearning4j_tpu_torch.observability import METRICS, TRACER
from deeplearning4j_tpu_torch.plot import tsne as TTS

from torch_port_obs import port_obs  # noqa: F401  (autouse)

CPU = "cpu"


def three_blobs(n=30, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0], [10, 10], [-10, 10]], np.float64)
    pts = np.concatenate([rng.normal(c, 0.5, (n, 2)) for c in centers])
    labels = np.repeat([0, 1, 2], n)
    return pts, labels


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _wide(seed=2, n=400, d=16, k=6):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4, (k, d))
    return (centers[rng.integers(0, k, n)]
            + rng.normal(0, 1, (n, d))).astype(np.float32)


# -------------------------------------------------------------------- k-means

@pytest.mark.parametrize("case", ["blobs", "wide"])
def test_lloyd_step_matches_reference(case):
    pts = (three_blobs()[0] if case == "blobs" else _wide()).astype(np.float32)
    k = 3 if case == "blobs" else 6
    cents = pts[np.random.default_rng(1).choice(len(pts), k, replace=False)]
    cents[-1] = 1e3                      # a centroid no point chooses
    c_j, a_j, i_j = JK._lloyd_step(jnp.asarray(pts), jnp.asarray(cents), k)
    c_t, a_t, i_t = TK._lloyd_step(torch.from_numpy(pts),
                                   torch.from_numpy(cents), k)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert _rel(c_t.numpy(), c_j) < 1e-5
    assert c_t[-1].eq(1e3).all()         # an empty cluster keeps its centroid
    assert abs(float(i_t) - float(i_j)) <= 1e-5 * float(i_j)


@pytest.mark.parametrize("case,k,seed", [("blobs", 3, 1), ("blobs", 5, 0),
                                         ("wide", 6, 3)])
def test_kmeans_fit_matches_reference(case, k, seed):
    pts = three_blobs()[0] if case == "blobs" else _wide()
    spans = []
    TRACER.add_listener(spans.append)
    got = TC.KMeansClustering(k=k, seed=seed, device=CPU).fit(pts)
    want = JC.KMeansClustering(k=k, seed=seed).fit(pts)
    assert _rel(got.centroids, want.centroids) < 1e-5
    np.testing.assert_array_equal(got.labels(), want.labels())
    assert abs(got.inertia - want.inertia) <= 1e-5 * want.inertia
    np.testing.assert_array_equal(got.predict(pts[:7]), want.predict(pts[:7]))
    fit = [s for s in spans if s["name"] == "kmeans.fit"]
    assert len(fit) == 1 and fit[0]["args"]["k"] == k
    sweeps = METRICS.snapshot()["counters"]["kmeans.sweeps"]
    assert 1 <= sweeps <= got.max_iterations


def test_kmeans_recovers_blobs():
    """The reference test on the port."""
    pts, labels = three_blobs()
    km = TC.KMeansClustering(k=3, seed=1, device=CPU).fit(pts)
    assign = km.labels()
    for c in range(3):
        vals, counts = np.unique(assign[labels == c], return_counts=True)
        assert counts.max() / counts.sum() > 0.95
    assert km.predict(pts[:5]).shape == (5,)


# ------------------------------------------------------------- spatial trees

def test_kdtree_matches_reference():
    rng = np.random.default_rng(3)
    pts = rng.random((200, 4))
    got, want = TC.KDTree(pts), JC.KDTree(pts)
    for _ in range(20):
        q = rng.random(4)
        assert got.nearest(q) == want.nearest(q)
        assert got.knn(q, 5) == want.knn(q, 5)
        idx, dist = got.nearest(q)
        brute = np.linalg.norm(pts - q, axis=1)
        assert idx == int(brute.argmin())
        assert dist == pytest.approx(float(brute.min()))
    lo, hi = [0.2, 0.2, 0.1, 0.3], [0.6, 0.9, 0.5, 0.8]
    assert got.range_search(lo, hi) == want.range_search(lo, hi)
    small = np.array([[0, 0], [1, 1], [2, 2], [5, 5]], np.float64)
    assert TC.KDTree(small).range_search([0.5, 0.5], [2.5, 2.5]) == [1, 2]


def test_vptree_matches_reference():
    rng = np.random.default_rng(4)
    pts = rng.random((150, 6))
    got, want = TC.VPTree(pts, seed=2), JC.VPTree(pts, seed=2)
    for _ in range(10):
        q = rng.random(6)
        assert got.knn(q, 7) == want.knn(q, 7)
        assert got.nearest(q) == want.nearest(q)
        brute = set(np.argsort(np.linalg.norm(pts - q, axis=1))[:7].tolist())
        assert {i for i, _ in got.knn(q, 7)} == brute


def test_quadtree_matches_reference():
    pts, _ = three_blobs(n=20)
    got, want = TC.QuadTree.build(pts), JC.QuadTree.build(pts)
    assert got.size == want.size == pts.shape[0]
    np.testing.assert_array_equal(got.com, want.com)
    np.testing.assert_allclose(got.com, pts.mean(axis=0), atol=1e-9)
    assert got.depth() == want.depth() >= 2
    for i in (0, 7, 33):
        for theta in (0.0, 0.5, 1.2):
            f, sq = got.compute_non_edge_forces(pts[i], theta, i)
            fw, sqw = want.compute_non_edge_forces(pts[i], theta, i)
            np.testing.assert_array_equal(f, fw)
            assert sq == sqw and sq > 0 and np.all(np.isfinite(f))
    assert got.contains(pts[0]) and not got.contains(np.array([1e6, 0.0]))


# -------------------------------------------------------------------- t-SNE

def test_pairwise_and_gradient_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 9)).astype(np.float32)
    d_j = np.asarray(JTS._pairwise_sq_dists(jnp.asarray(x)))
    d_t = TTS._pairwise_sq_dists(torch.from_numpy(x)).numpy()
    assert _rel(d_t, d_j) < 1e-5 and (d_t >= 0).all()
    y = rng.normal(0, 1e-2, (50, 2)).astype(np.float32)
    P = rng.random((50, 50)).astype(np.float32)
    P = (P + P.T) / (2 * P.sum())
    g_j, kl_j = JTS._tsne_grad(jnp.asarray(y), jnp.asarray(P))
    g_t, kl_t = TTS._tsne_grad(torch.from_numpy(y), torch.from_numpy(P))
    assert _rel(g_t.numpy(), g_j) < 1e-5
    assert abs(float(kl_t) - float(kl_j)) <= 1e-5 * abs(float(kl_j))


@pytest.mark.parametrize("perplexity", [5.0, 10.0])
def test_input_probs_match_reference(perplexity):
    # points about the origin: the reference's own |x|^2 - 2 x.y + |y|^2
    # loses ~1e-4 of a near distance to cancellation when |x| is ~20
    # times the distance (three_blobs), and P follows its distances
    x = np.random.default_rng(2).normal(size=(60, 5)).astype(np.float32)
    got = TTS.Tsne(perplexity=perplexity, device=CPU)._input_probs(x)
    want = JTS.Tsne(perplexity=perplexity)._input_probs(x)
    assert got.dtype == want.dtype == np.float32
    assert _rel(got, want) < 1e-5
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-4)
    # the host search itself is the reference's, bit for bit
    pts, _ = three_blobs(n=20, seed=5)
    d2 = np.asarray(JTS._pairwise_sq_dists(jnp.asarray(pts, jnp.float32)))
    np.testing.assert_array_equal(
        TTS.binary_search_perplexity(d2, perplexity),
        JTS.binary_search_perplexity(d2, perplexity))


# 20 iterations at learning rates where the trajectory is stable.  At the
# defaults (200, exaggeration 4) these small sets are chaotic: from the
# same P and y, the reference and the port (summation order alone) part
# by 1e-7 after one iteration and by ~0.7 of the scale after 20 (three
# blobs, n=60); at n=5000 x 100 by 1.8e-4 of the scale after 20
@pytest.mark.parametrize("kw", [
    dict(learning_rate=10.0, early_exaggeration=1.5, exaggeration_iters=10),
    dict(learning_rate=5.0, early_exaggeration=2.0, exaggeration_iters=10,
         seed=3)])
def test_tsne_fit_transform_matches_reference(kw):
    pts, _ = three_blobs(n=20, seed=5)
    got_m = TTS.Tsne(perplexity=10, n_iter=20, device=CPU, **kw)
    want_m = JTS.Tsne(perplexity=10, n_iter=20, **kw)
    got, want = got_m.fit_transform(pts), want_m.fit_transform(pts)
    assert got.shape == want.shape == (60, 2) and got.dtype == np.float32
    assert _rel(got, want) < 1e-4
    assert abs(got_m.kl_ - want_m.kl_) <= 1e-4 * abs(want_m.kl_)


def test_tsne_descends_in_the_dtype_of_y():
    """Float64 iterations (the card phase holds the card to the CPU so)
    stay float64 and agree with float32 ones at a stable rate."""
    pts, _ = three_blobs(n=20, seed=5)
    m = TTS.Tsne(perplexity=10, n_iter=20, learning_rate=10.0, device=CPU)
    P = m._input_probs(pts)
    y0 = np.random.default_rng(0).normal(0, 1e-4, (60, 2))
    y64 = m._descend(P.astype(np.float64), torch.from_numpy(y0))
    y32 = m._descend(P, torch.from_numpy(y0.astype(np.float32)))
    assert y64.dtype == np.float64 and y32.dtype == np.float32
    assert _rel(y32, y64) < 1e-4


def test_exact_tsne_separates_blobs():
    """The reference test on the port."""
    pts, labels = three_blobs(n=20, seed=5)
    emb = TPL.Tsne(perplexity=10, n_iter=250, seed=0,
                   device=CPU).fit_transform(pts)
    assert emb.shape == (60, 2)
    within = np.mean([np.linalg.norm(emb[labels == c]
                                     - emb[labels == c].mean(0), axis=1).mean()
                      for c in range(3)])
    centers = np.stack([emb[labels == c].mean(0) for c in range(3)])
    between = np.mean([np.linalg.norm(centers[i] - centers[j])
                       for i in range(3) for j in range(i + 1, 3)])
    assert between > 3 * within


def test_barnes_hut_tsne_matches_reference():
    pts, _ = three_blobs(n=12, seed=6)
    kw = dict(theta=0.5, perplexity=8, n_iter=120, seed=0)
    got = TPL.BarnesHutTsne(**kw).fit_transform(pts)
    want = JPL.BarnesHutTsne(**kw).fit_transform(pts)
    assert got.shape == (36, 2) and np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, want)
    assert TPL.BarnesHutTsne().device.type == "cpu"


# ------------------------------------------------------------ render / plots

def _files(root):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*")
                  if p.is_file())


def test_renderers_write_the_references_files(tmp_path):
    from deeplearning4j_tpu.plot import renderers as JR
    from deeplearning4j_tpu_torch.plot import renderers as TR

    for pkg, root in ((TR, tmp_path / "port"), (JR, tmp_path / "ref")):
        root.mkdir()
        rng = np.random.default_rng(0)
        params = [{"W": rng.random((16, 4)), "b": rng.random(4)},
                  {"W": rng.random((4, 3))}]
        grads = [{"W": rng.random((16, 4)), "b": rng.random(4)},
                 {"W": rng.random((4, 3))}]
        files = pkg.NeuralNetPlotter().plot_network_gradient(params, grads,
                                                             root / "net")
        assert files and all(f.exists() for f in files)
        pkg.NeuralNetPlotter().plot_activations(
            [rng.random((8, 5)), rng.random((8, 3))], root / "act.png")
        pkg.FilterRenderer().render_filters(rng.random((16, 9)),
                                            root / "f.png")
        pkg.draw_mnist_grid(rng.random((12, 64)), root / "g.png")
        pkg.plot_vocab_2d(["a", "b", "c"], rng.random((3, 2)),
                          root / "v.png")
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert len(_files(tmp_path / "port")) >= 5


def test_embedding_render_server_serves_page_and_coords():
    words = ["alpha", "beta", "gamma"]
    coords = np.array([[0.0, 0.0], [1.0, 2.0], [-1.0, 0.5]])
    srv = TPL.EmbeddingRenderServer(words, coords).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        page = urllib.request.urlopen(base + "/", timeout=10).read().decode()
        assert "canvas" in page and "api/coords" in page
        data = json.loads(urllib.request.urlopen(
            base + "/api/coords", timeout=10).read())
        assert [d["word"] for d in data] == words
        assert data[1] == {"word": "beta", "x": 1.0, "y": 2.0}
        srv.update(words, coords + 1.0)
        data2 = json.loads(urllib.request.urlopen(
            base + "/api/coords", timeout=10).read())
        assert data2[0]["x"] == 1.0
        with pytest.raises(ValueError):
            srv.update(words, np.zeros((2, 2)))
    finally:
        srv.stop()


def test_render_word_vectors_from_word2vec():
    from deeplearning4j_tpu_torch.plot.render_app import render_word_vectors
    from deeplearning4j_tpu_torch.text.word2vec import Word2Vec

    corpus = ["the cat sat on the mat", "the dog sat on the rug",
              "cats and dogs play"] * 10
    w2v = Word2Vec(corpus, layer_size=16, min_word_frequency=1, iterations=2,
                   seed=0, device=CPU)
    w2v.fit()
    srv = render_word_vectors(w2v, max_words=10, n_iter=50, device=CPU)
    try:
        data = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/api/coords", timeout=10).read())
        assert 1 < len(data) <= 10
        assert [d["word"] for d in data] == w2v.vocab.words()[:10]
        assert all(np.isfinite([d["x"], d["y"]]).all() for d in data)
    finally:
        srv.stop()
