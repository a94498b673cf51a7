"""The port's native host runtime, svmlight IO, CSV fast path and record
readers against the JAX package's.

Both packages compile the same ``host_runtime.cpp`` (each its own copy)
and parse on the host into numpy, so equal means bitwise here: the
native results, the Python fallbacks and the parsed arrays.  The port's
library builds into its own build directory, never beside the source,
and six processes building it at once leave one good library.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import fetchers as JF
from deeplearning4j_tpu.datasets import records as JR
from deeplearning4j_tpu.datasets import svmlight as JS
from deeplearning4j_tpu.native import runtime as JN
from deeplearning4j_tpu.text import DefaultTokenizerFactory as JTF
from deeplearning4j_tpu.text import build_vocab as j_build_vocab
from deeplearning4j_tpu.text.tokenization import CommonPreprocessor as JCP
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets import fetchers as TF
from deeplearning4j_tpu_torch.datasets import records as TR
from deeplearning4j_tpu_torch.datasets import svmlight as TS
from deeplearning4j_tpu_torch.native import build as TB
from deeplearning4j_tpu_torch.native import runtime as TN
from deeplearning4j_tpu_torch.text import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.text import build_vocab
from deeplearning4j_tpu_torch.text.tokenization import CommonPreprocessor

ROOT = Path(__file__).resolve().parents[1]

CORPUS = [
    "the apple is a sweet fruit",
    "banana is a yellow fruit and the banana is sweet",
    "Orange fruit, is sweet; and orange is juicy!",
    "the car drives on the road",
    "a truck is a big car on the road",
    "car truck and bus are vehicles on the road",
] * 5


def _sentences(seed=0, n=40, vocab=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(1, 12)).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def libs():
    t, j = TN.lib(), JN.lib()
    assert t is not None, "the port's native library did not build"
    if j is None:
        pytest.skip("the reference's native library is unavailable")
    return t, j


# --------------------------------------------------------------------------- the library

def test_port_library_builds_into_its_build_directory(libs):
    path = TB.lib_path()
    assert path.exists()
    if not os.environ.get("DL4J_TORCH_BUILD_DIR"):
        assert path == ROOT / "deeplearning4j_tpu_torch" / "_build" / TB.LIB_NAME
    assert TB.SRC.parent.parent == ROOT / "deeplearning4j_tpu_torch" / "native"
    assert not list(TB.SRC.parent.glob("*.so"))   # never beside the source
    for sym in ("drt_count_tokens", "drt_free", "drt_skipgram_pairs",
                "drt_cooccurrence", "drt_parse_svmlight",
                "drt_parse_csv_floats"):
        assert hasattr(libs[0], sym)
    assert not TB.stale(path)


def test_port_source_is_the_reference_source_apart_from_its_header():
    ref = (ROOT / "deeplearning4j_tpu/native/src/host_runtime.cpp").read_text()
    port = TB.SRC.read_text()
    body = ref[ref.index('extern "C" {'):]
    assert port.endswith(body)


_BUILD_ONE = (
    "from deeplearning4j_tpu_torch.native import runtime\n"
    "l = runtime.lib()\n"
    "assert l is not None\n"
    "import numpy as np\n"
    "out = runtime.skipgram_pairs([np.arange(9, dtype=np.int32)], 3, 7)\n"
    "print(int(out[0].sum()), int(out[1].sum()), len(out[0]))\n")


def test_concurrent_first_builds_leave_one_good_library(tmp_path):
    """Six processes ask for the library at once in an empty build
    directory (as six test workers do): each loads a whole library and
    gets the same pairs; one library and no temporary file remain."""
    env = dict(os.environ, DL4J_TORCH_BUILD_DIR=str(tmp_path),
               PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append(out.strip())
    assert len(set(outs)) == 1 and outs[0]
    files = sorted(f.name for f in tmp_path.iterdir())
    assert files == [TB.LIB_NAME, f"{TB.LIB_NAME}.lock"], files
    want = TN.skipgram_pairs([np.arange(9, dtype=np.int32)], 3, 7)
    assert outs[0] == f"{int(want[0].sum())} {int(want[1].sum())} {len(want[0])}"


def test_build_is_stale_when_the_source_is_newer(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_BUILD_DIR", str(tmp_path))
    lib = TB.lib_path()
    assert lib.parent == tmp_path and TB.stale(lib)
    assert TB.build(verbose=False, force=False) == lib
    assert not TB.stale(lib)
    old = TB.SRC.stat().st_mtime
    os.utime(lib, (old - 10, old - 10))
    assert TB.stale(lib)


# --------------------------------------------------------------------------- native results

def test_count_tokens_equals_the_reference_and_the_fallback(libs):
    t = TN.count_tokens(CORPUS, DefaultTokenizerFactory(CommonPreprocessor()))
    j = JN.count_tokens(CORPUS, JTF(JCP()))
    assert t == j and list(t) == list(j)        # same words, same order
    tf = DefaultTokenizerFactory(CommonPreprocessor())
    slow = build_vocab(CORPUS, tf, use_native=False)
    fast = build_vocab(CORPUS, tf, use_native=True)
    assert set(fast.words()) == set(slow.words())
    for w in slow.words():
        assert fast.count_of(w) == slow.count_of(w) == t[w], w
    # the fallback's conditions: no preprocessor, non-ASCII text
    assert TN.count_tokens(CORPUS, DefaultTokenizerFactory()) is None
    assert TN.count_tokens(["café au lait"], tf) is None
    ref = j_build_vocab(CORPUS, JTF(JCP()))
    assert fast.words() == ref.words()


@pytest.mark.parametrize("window,seed", [(2, 123), (5, 1), (3, 2**62 + 5)])
def test_skipgram_pairs_equal_the_reference_bitwise(libs, window, seed):
    sents = _sentences(seed % 97)
    tc, tx = TN.skipgram_pairs(sents, window, seed)
    jc, jx = JN.skipgram_pairs(sents, window, seed)
    assert tc.dtype == jc.dtype == np.int32
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tx, jx)
    # no pair crosses a sentence boundary (the reference's own check)
    first = set(range(5))
    c, x = TN.skipgram_pairs([np.array([0, 1, 2, 3, 4], np.int32),
                              np.array([5, 6, 7], np.int32)], 2, seed)
    assert all((a in first) == (b in first) for a, b in zip(c, x))


def test_skipgram_pairs_fallback_equals_the_reference_fallback(monkeypatch):
    """Without the library, both packages' Python pair generators draw the
    same window shrinks from the same numpy generator."""
    from deeplearning4j_tpu_torch.text import word2vec as TW

    sents = _sentences(3)
    monkeypatch.setattr(TN, "skipgram_pairs", lambda *a: None)
    c, x = TW.skipgram_pairs(sents, 2, np.random.default_rng(0))
    from deeplearning4j_tpu.text import word2vec as JW
    monkeypatch.setattr(JN, "skipgram_pairs", lambda *a: None)
    jc, jx = JW.skipgram_pairs(sents, 2, np.random.default_rng(0))
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(x, jx)


def test_cooccurrence_equals_the_reference_and_the_fallback(libs):
    sents = _sentences(4)
    rows, cols, vals = TN.cooccurrence(sents, window=3)
    jr, jc, jv = JN.cooccurrence(sents, window=3)
    np.testing.assert_array_equal(rows, jr)
    np.testing.assert_array_equal(cols, jc)
    np.testing.assert_array_equal(vals, jv)
    from collections import defaultdict
    want = defaultdict(float)
    for idx in sents:
        for pos, wi in enumerate(idx):
            for off in range(1, 4):
                j = pos + off
                if j >= len(idx):
                    break
                want[(int(wi), int(idx[j]))] += 1.0 / off
                want[(int(idx[j]), int(wi))] += 1.0 / off
    got = {(int(r), int(c)): float(v) for r, c, v in zip(rows, cols, vals)}
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-5, (k, got[k], want[k])


def test_parse_csv_floats_equals_the_reference(libs):
    rng = np.random.default_rng(2)
    grid = rng.standard_normal((17, 5)).astype(np.float32)
    text = "\n".join(",".join(f"{v:.7g}" for v in row) for row in grid) + "\n"
    t, j = TN.parse_csv_floats(text, 5), JN.parse_csv_floats(text, 5)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(t, grid, rtol=1e-6)
    assert TN.parse_csv_floats("1,2\n3\n", 2) is None     # ragged
    assert TN.parse_csv_floats("1,x\n", 2) is None        # not numeric


# --------------------------------------------------------------------------- svmlight

def _svm_file(tmp_path, seed=5, n=50, d=9, c=4, name="n.svmlight"):
    rng = np.random.default_rng(seed)
    feats = np.where(rng.random((n, d)) < 0.35,
                     rng.random((n, d)).astype(np.float32), 0.0)
    labels = rng.integers(0, c, n)
    p = tmp_path / name
    TS.save_svmlight(p, feats, labels)
    with open(p, "a") as f:
        f.write("# trailing comment line\n\n2 3:0.5 # inline\n")
    return p, feats, labels


def test_load_svmlight_native_python_and_reference_agree(tmp_path, libs,
                                                        monkeypatch):
    p, _, _ = _svm_file(tmp_path)
    f_native, l_native = TS.load_svmlight(p, 9, 4)
    f_ref, l_ref = JS.load_svmlight(p, 9, 4)
    monkeypatch.setattr(TN, "parse_svmlight", lambda *a: None)
    f_py, l_py = TS.load_svmlight(p, 9, 4)
    for f, l in ((f_py, l_py), (f_ref, l_ref)):
        np.testing.assert_array_equal(f_native, f)
        np.testing.assert_array_equal(l_native, l)
    assert f_native.shape == (51, 9)


def test_save_svmlight_writes_the_reference_bytes(tmp_path):
    rng = np.random.default_rng(0)
    feats = np.where(rng.random((20, 8)) < 0.4,
                     rng.random((20, 8)).astype(np.float32), 0.0)
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 20)]
    TS.save_svmlight(tmp_path / "t", feats, onehot)
    JS.save_svmlight(tmp_path / "j", feats, onehot)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


# the reference's svmlight tests (tests/test_svmlight.py), against the port

def test_parse_line_matches_reference_semantics():
    vec, label = TS.parse_svmlight_line("1 1:0.43 3:0.12 5:0.2 # abcdef", 6)
    assert label == 1.0
    np.testing.assert_allclose(vec, [0.43, 0.0, 0.12, 0.0, 0.2, 0.0])
    with pytest.raises(ValueError, match="0-based"):
        TS.parse_svmlight_line("1 0:0.5", 6)
    with pytest.warns(UserWarning, match="beyond"):
        vec, _ = TS.parse_svmlight_line("0 2:1.0 99:3.0", 4)
    np.testing.assert_allclose(vec, [0.0, 1.0, 0.0, 0.0])
    with pytest.raises(TS.SVMLightVectorNoLabelError):
        TS.parse_svmlight_line("   # only a comment", 4)


def test_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    feats = np.where(rng.random((20, 8)) < 0.4,
                     rng.random((20, 8)).astype(np.float32), 0.0)
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 20)]
    p = tmp_path / "t.svmlight"
    TS.save_svmlight(p, feats, onehot)
    f2, l2 = TS.load_svmlight(p, 8, 3)
    np.testing.assert_allclose(f2, feats, atol=1e-6)
    np.testing.assert_array_equal(l2, onehot)


def test_byte_range_splits_partition_records(tmp_path):
    feats = np.arange(30, dtype=np.float32).reshape(10, 3)
    labels = np.arange(10) % 2
    p = tmp_path / "s.svmlight"
    TS.save_svmlight(p, feats, labels)
    size = p.stat().st_size
    cuts = [0, size // 3, (2 * size) // 3, size]
    rows = []
    for s, e in zip(cuts, cuts[1:]):
        f, _ = TS.load_svmlight(p, 3, 2, start=s, end=e)
        j, _ = JS.load_svmlight(p, 3, 2, start=s, end=e)
        np.testing.assert_array_equal(f, j)
        rows.extend(f.tolist())
    np.testing.assert_allclose(np.asarray(rows), feats)


def test_fetcher_and_iterator(tmp_path):
    p = tmp_path / "f.svmlight"
    TS.save_svmlight(p, np.eye(6, dtype=np.float32), np.arange(6) % 3)
    fetcher = TS.SVMLightDataFetcher(p, 6, 3)
    fetcher.fetch(4)
    ds = fetcher.next()
    assert isinstance(ds, DataSet)
    assert ds.num_examples() == 4
    assert fetcher.has_more()
    fetcher.fetch(4)                       # clamps to the 2 remaining
    assert fetcher.next().num_examples() == 2
    assert not fetcher.has_more()
    fetcher.reset()
    assert fetcher.has_more()
    it = TS.SVMLightDataSetIterator(p, batch=4, num_features=6, num_classes=3)
    batches = [it.next() for _ in range(2) if it.has_next()]
    assert [b.num_examples() for b in batches] == [4, 2]


def test_train_zoo_mlp_from_svmlight_file(tmp_path):
    """fetch -> train on the CPU: an MLP learns a linearly separable
    svmlight corpus (the reference's test, through the port's zoo)."""
    from deeplearning4j_tpu_torch.models.zoo import mlp

    rng = np.random.default_rng(1)
    n, d = 120, 6
    idx = rng.integers(0, 2, n)
    feats = (rng.standard_normal((n, d)).astype(np.float32)
             + 2.5 * idx[:, None] * np.eye(d, dtype=np.float32)[0])
    feats = np.where(np.abs(feats) < 0.1, 0.0, feats)
    p = tmp_path / "train.svmlight"
    TS.save_svmlight(p, feats, idx)
    it = TS.SVMLightDataSetIterator(p, batch=40, num_features=d, num_classes=2)
    net = mlp(d, 2, hidden=(16,), num_iterations=60, device="cpu")
    while it.has_next():
        net.fit(it.next())
    f2, l2 = TS.load_svmlight(p, d, 2)
    acc = (net.predict(f2) == l2.argmax(-1)).mean()
    assert acc > 0.85, f"svmlight-trained MLP accuracy {acc}"


def test_native_parser_error_semantics(tmp_path, libs):
    bad = tmp_path / "bad.svmlight"
    bad.write_text("1 0:0.5\n")
    with pytest.raises(ValueError, match="0-based"):
        TS.load_svmlight(bad, 4, 2)
    warn = tmp_path / "warn.svmlight"
    warn.write_text("1 2:1.0 99:3.0\n")
    with pytest.warns(UserWarning, match="beyond"):
        f, _ = TS.load_svmlight(warn, 4, 2)
    np.testing.assert_allclose(f, [[0.0, 1.0, 0.0, 0.0]])
    for text in ("1 2:\n3 1:1\n", "1 2: 0.5\n"):
        mal = tmp_path / "mal.svmlight"
        mal.write_text(text)
        with pytest.raises(ValueError):
            TS.load_svmlight(mal, 4, 2)
    inf = tmp_path / "inf.svmlight"
    inf.write_text("inf 1:0.5\n")
    with pytest.raises(ValueError, match="non-negative integer"):
        TS.load_svmlight(inf, 4, 2)


# --------------------------------------------------------------------------- CSV fetcher

def _csv(tmp_path, numeric=True):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((30, 4)).astype(np.float32)
    y = rng.integers(0, 3, 30)
    lab = [str(int(v)) if numeric else ("abc"[v] * 2) for v in y]
    p = tmp_path / ("n.csv" if numeric else "s.csv")
    p.write_text("\n".join(",".join([f"{v:.6g}" for v in row] + [l])
                           for row, l in zip(x, lab)) + "\n")
    return p


@pytest.mark.parametrize("numeric", [True, False])
def test_csv_fetcher_fast_path_equals_the_reference(tmp_path, libs, numeric,
                                                    monkeypatch):
    p = _csv(tmp_path, numeric)
    calls = []
    orig = TN.parse_csv_floats
    monkeypatch.setattr(TN, "parse_csv_floats",
                        lambda *a: calls.append(1) or orig(*a))
    t, j = TF.CSVDataFetcher(p), JF.CSVDataFetcher(p)
    t.fetch(30)
    j.fetch(30)
    np.testing.assert_array_equal(t.next().features, j.next().features)
    np.testing.assert_array_equal(t.next().labels, j.next().labels)
    assert calls == [1]
    # the fast path and the Python path give the same features
    monkeypatch.setattr(TN, "parse_csv_floats", lambda *a: None)
    s = TF.CSVDataFetcher(p)
    s.fetch(30)
    np.testing.assert_array_equal(s.next().features, t.next().features)


# --------------------------------------------------------------------------- record readers

def test_record_readers(tmp_path):
    """The reference's test (tests/test_subsystems.py) against the port,
    and each reader's batches against the reference's."""
    p = tmp_path / "r.csv"
    p.write_text("1.0,2.0,cat\n3.0,4.0,dog\n5.0,6.0,cat\n")
    rr = TR.CSVRecordReader(p)
    it = TR.RecordReaderDataSetIterator(rr, batch=2, label_index=2)
    ds = it.next()
    assert ds.features.shape == (2, 2)
    assert it.total_outcomes() == 2
    rr2 = TR.CollectionRecordReader([[0.1, 0.2], [0.3, 0.4]])
    unsup = TR.RecordReaderDataSetIterator(rr2, batch=2, label_index=None)
    b = unsup.next()
    np.testing.assert_array_equal(b.features, b.labels)
    jt = JR.RecordReaderDataSetIterator(JR.CSVRecordReader(p), batch=2,
                                        label_index=2)
    jb = jt.next()
    np.testing.assert_array_equal(ds.features, jb.features)
    np.testing.assert_array_equal(ds.labels, jb.labels)


def test_line_and_collection_readers_equal_the_reference(tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("first line\n\nsecond line\nthird\n")
    t, j = TR.LineRecordReader(p), JR.LineRecordReader(p)
    assert t.records == j.records == [["first line"], ["second line"],
                                      ["third"]]
    rows = [[1, 2, 0], [3, 4, 1], [5, 6, 1], [7, 8, 0]]
    ti = TR.RecordReaderDataSetIterator(TR.CollectionRecordReader(rows),
                                        batch=3, label_index=-1,
                                        num_classes=2)
    ji = JR.RecordReaderDataSetIterator(JR.CollectionRecordReader(rows),
                                        batch=3, label_index=-1,
                                        num_classes=2)
    while ji.has_next():
        a, b = ti.next(), ji.next()
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert not ti.has_next()


def test_image_record_reader_equals_the_reference(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(6)
    for label in ("cat", "dog"):
        (tmp_path / label).mkdir()
        for i in range(3):
            arr = rng.integers(0, 256, (10, 12), dtype=np.uint8)
            Image.fromarray(arr).save(tmp_path / label / f"{i}.png")
    t = TR.ImageRecordReader(tmp_path, size=(8, 8))
    j = JR.ImageRecordReader(tmp_path, size=(8, 8))
    assert t.records == j.records and len(t.records) == 6
    ti = TR.RecordReaderDataSetIterator(t, batch=6, label_index=-1,
                                        num_classes=2)
    b = ti.next()
    assert b.features.shape == (6, 64) and b.labels.sum() == 6


def test_records_module_does_not_import_pil_at_import():
    code = ("import sys; import deeplearning4j_tpu_torch.datasets.records; "
            "print('PIL' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
