"""The port's host utilities (``deeplearning4j_tpu_torch.utils``: counters,
misc, stringgrid) against the JAX package's, on the CPU.

Each case runs the same calls, the reference tests' own
(``tests/test_models_utils.py``, ``tests/test_stringgrid_curves.py``) and
more, through both packages, asserts the reference tests' expectations on
the port's answer, and requires the two answers to be equal.  The
package's ``__all__`` is the reference's.
"""

import tarfile
import zipfile

import numpy as np
import pytest

from deeplearning4j_tpu import utils as JU
from deeplearning4j_tpu.utils import misc as JM
from deeplearning4j_tpu.utils import stringgrid as JS
from deeplearning4j_tpu_torch import utils as TU
from deeplearning4j_tpu_torch.utils import misc as TM
from deeplearning4j_tpu_torch.utils import stringgrid as TS

PKGS = {"ref": (JU, JM, JS), "port": (TU, TM, TS)}


def test_utils_exports_the_references_names():
    assert TU.__all__ == JU.__all__
    for name in TU.__all__:
        assert hasattr(TU, name), name


# ------------------------------------------------------------------ counters

def _counter(U, M, S, tmp):
    c = U.Counter(["a", "b", "a", "c", "c", "c"])
    out = [c.get_count("a"), c.argmax(), c.max_count(), c.total_count(),
           c.sorted_keys(), "a" in c, len(c)]
    c.increment("b", 2.5)
    c.set_count("d", 0.25)
    c.prune_below(0.5)
    out += [sorted(c.items()), c.sorted_keys()]
    c.keep_top_n(2)
    out += [sorted(c)]
    c.remove("c")
    c.normalize()
    out += [sorted(c.items()), c.total_count()]
    return out


def _counter_map(U, M, S, tmp):
    cm = U.CounterMap()
    cm.increment("x", "y", 2.0)
    cm.increment("x", "z")
    cm.increment("w", "y", 3.0)
    out = [cm.get_count("x", "y"), cm.get_count("q", "y"), cm.total_count(),
           sorted(cm.keys()), len(cm), "w" in cm,
           sorted(cm.get_counter("x").items())]
    cm.normalize()
    out += [sorted(cm.get_counter("x").items()), cm.total_count()]
    return out


def _index(U, M, S, tmp):
    idx = U.Index(["w1", "w2"])
    out = [idx.index_of("w2"), idx.get(0), idx.add("w1"), len(idx),
           idx.add("w3"), idx.index_of("nope"), "w3" in idx, list(idx)]
    return out


# ---------------------------------------------------------------------- misc

def _math(U, M, S, tmp):
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=7), rng.normal(size=7)
    return [M.entropy([0.5, 0.5]), M.entropy([0.2, 0.0, 0.8]),
            M.information_gain([4, 4], [[3, 1], [1, 3]]),
            M.information_gain([5, 5], [[5, 0], [0, 5], [0, 0]]),
            M.euclidean_distance(a, b), M.manhattan_distance(a, b),
            M.correlation(a, b), M.correlation([1, 1, 1], b[:3]),
            M.sigmoid(0.3), M.sigmoid(-4.0),
            M.bernoulli_log_likelihood([1, 0, 1], [0.9, 0.2, 1.0]),
            M.normalize_to_range([3.0, 1.0, 2.0]).tolist(),
            M.normalize_to_range([2.0, 2.0], 1.0, 5.0).tolist(),
            M.normalize_to_range([0.0, 4.0], -1.0, 1.0).tolist()]


def _summary_statistics(U, M, S, tmp):
    s = U.SummaryStatistics()
    s.add_all([1.0, 2.0, 3.0, 4.0])
    one = U.SummaryStatistics()
    one.add(7.0)
    out = [s.n, s.mean, s.variance, s.std, s.min, s.max, str(s),
           one.variance, one.std, str(one)]
    assert s.mean == pytest.approx(2.5)
    assert s.std == pytest.approx(np.std([1, 2, 3, 4], ddof=1))
    assert M.entropy([0.5, 0.5]) == pytest.approx(np.log(2))
    return out


def _disk_queue(U, M, S, tmp):
    q = U.DiskBasedQueue(tmp / "q", memory_window=3)
    for i in range(10):
        q.add({"i": i, "sq": [i] * i})
    n = len(q)
    got = [q.poll() for _ in range(10)]
    empty = q.is_empty()
    q.add("again")
    tail = [len(q), q.poll(), q.is_empty()]
    q.close()
    assert n == 10 and empty and [g["i"] for g in got] == list(range(10))
    return [n, got, empty, tail]


def _moving_window(U, M, S, tmp):
    m = np.arange(16).reshape(4, 4)
    wins = M.moving_window_matrix(m, 2, 2)
    rot = M.moving_window_matrix(m, 2, 2, add_rotations=True)
    odd = M.moving_window_matrix(np.arange(15).reshape(3, 5), 2, 2)
    none = M.moving_window_matrix(np.arange(4).reshape(2, 2), 3, 3)
    assert wins.shape == (4, 4) and rot.shape == (16, 4)
    return [wins.tolist(), rot.tolist(), odd.tolist(), none.shape]


def _serde_and_archives(U, M, S, tmp):
    M.save_object({"a": 1, "b": [1, 2]}, tmp / "o.pkl")
    back = M.read_object(tmp / "o.pkl")
    src = tmp / "src"
    src.mkdir()
    (src / "f.txt").write_text("hello")
    with zipfile.ZipFile(tmp / "a.zip", "w") as z:
        z.write(src / "f.txt", "f.txt")
    with tarfile.open(tmp / "a.tar.gz", "w:gz") as t:
        t.add(src / "f.txt", "g.txt")
    M.unzip_file_to(tmp / "a.zip", tmp / "z")
    M.unzip_file_to(tmp / "a.tar.gz", tmp / "t")
    with pytest.raises(ValueError):
        M.unzip_file_to(tmp / "o.pkl", tmp / "x")
    return [back, (tmp / "z" / "f.txt").read_text(),
            (tmp / "t" / "g.txt").read_text()]


# ----------------------------------------------------------------- stringgrid

def _fingerprints(U, M, S, tmp):
    assert S.fingerprint("Two words") == S.fingerprint("TWO words")
    assert S.fingerprint("Two words") == S.fingerprint("WORDS TWO")
    assert S.fingerprint("  Héllo,  World! ") == "hello world"
    assert S.ngram_fingerprint("ab ba", 2) == S.ngram_fingerprint("ABba", 2)
    return [S.fingerprint(s) for s in ("Two words", "  Héllo,  World! ",
                                       "a-b a.b", "")] + \
        [S.ngram_fingerprint(s, n) for s, n in (("ab ba", 2), ("Hello", 3),
                                               ("x", 2))]


def _string_cluster(U, M, S, tmp):
    c = S.StringCluster(["Two words", "TWO words", "words two", "other",
                         "Other", "unique"])
    clusters = c.clusters()
    assert len(c) == 3
    assert sum(clusters[0].values()) == 3 and len(clusters[0]) == 3
    assert sum(clusters[-1].values()) == 1
    return [sorted(c.keys()), [sorted(k.items()) for k in clusters]]


def _string_grid_ops(U, M, S, tmp):
    f = tmp / "g.csv"
    f.write_text('a,"x,y",1\nb,z,2\nb,z,\n')
    g = S.StringGrid.from_file(f)
    out = [g.num_columns(), g[0][1], list(map(list, g.head(2)))]
    g.remove_rows_with_empty_column(2)
    out += [len(g), g.get_column(0)]
    g.remove_columns(2)
    out += [g.num_columns(), g.rows_with_column_values({"b"}, 0),
            g.filter_rows_by_column(0, {"a"}),
            g.to_lines()]
    g.write_file(tmp / "out.csv")
    out.append((tmp / "out.csv").read_text())
    g2 = S.StringGrid.from_lines(["p;q", "r;s"], sep=";")
    out += [list(map(list, g2)), g2.to_lines()]
    assert out[0] == 3 and out[1] == "x,y" and out[3] == 2
    assert out[6] == [["b", "z"]]
    return out


def _string_grid_dedupe(U, M, S, tmp):
    g = S.StringGrid(",", [["ACME Inc", "1"], ["acme inc", "2"],
                           ["ACME  inc.", "3"], ["Widgets LLC", "4"]])
    clusters = g.cluster_column(0)
    g.dedupe_by_cluster(0)
    col = g.get_column(0)
    assert len(set(col[:3])) == 1
    assert col[3] == "Widgets LLC"
    assert len(g.unique_rows()) == 4
    h = S.StringGrid(",", [["A b", "B a"], ["a B", "b A"], ["a b", "x"]])
    h.dedupe_by_cluster_all()
    return [sorted(clusters.keys()), list(map(list, g)),
            list(map(list, g.unique_rows())), list(map(list, h))]


def _string_grid_sort(U, M, S, tmp):
    g = S.StringGrid(",", [["rare phrase"], ["the cat"], ["the the the"]])
    g.sort_by_word_likelihood(0)
    assert g[0] == ["the the the"]
    return list(map(list, g))


CASES = {f.__name__.lstrip("_"): f for f in (
    _counter, _counter_map, _index, _math, _summary_statistics, _disk_queue,
    _moving_window, _serde_and_archives, _fingerprints, _string_cluster,
    _string_grid_ops, _string_grid_dedupe, _string_grid_sort)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_gives_the_references_outputs(case, tmp_path):
    want = CASES[case](*PKGS["ref"], tmp_path / "ref")
    got = CASES[case](*PKGS["port"], tmp_path / "port")
    assert got == want


@pytest.fixture(autouse=True)
def _dirs(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
