"""The port's fetchers, IDX files and dataset iterators against the JAX
package's (host-side numpy on both sides, so equal means bitwise)."""

import gzip

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import fetchers as JF
from deeplearning4j_tpu.datasets import iterator as JI
from deeplearning4j_tpu.datasets import mnist_idx as JM
from deeplearning4j_tpu_torch import datasets as TD
from deeplearning4j_tpu_torch.datasets import fetchers as TF
from deeplearning4j_tpu_torch.datasets import iterator as TI
from deeplearning4j_tpu_torch.datasets import mnist_idx as TM


def _same(a, b):
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.labels, b.labels)


def test_curves_are_bitwise_equal():
    t = TF.CurvesDataFetcher(n_examples=50, seed=3)
    j = JF.CurvesDataFetcher(n_examples=50, seed=3)
    t.fetch(50)
    j.fetch(50)
    _same(t.next(), j.next())
    assert t.total_examples() == 50 and t.input_columns == 784
    assert t.next().features.sum() > 0


def _images(n=7, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 28, 28), dtype=np.uint8),
            rng.integers(0, 10, n).astype(np.uint8))


@pytest.mark.parametrize("writer,reader", [(TM, JM), (JM, TM), (TM, TM)])
def test_idx_round_trip_in_both_directions(tmp_path, writer, reader):
    imgs, lbls = _images()
    writer.write_idx_images(tmp_path / "i", imgs)
    writer.write_idx_labels(tmp_path / "l", lbls)
    np.testing.assert_array_equal(reader.read_idx_images(tmp_path / "i"), imgs)
    np.testing.assert_array_equal(reader.read_idx_labels(tmp_path / "l"), lbls)
    assert (tmp_path / "i").read_bytes()[:4] == b"\x00\x00\x08\x03"
    # gzipped files read the same
    with gzip.open(tmp_path / "i.gz", "wb") as f:
        f.write((tmp_path / "i").read_bytes())
    np.testing.assert_array_equal(TM.read_idx_images(tmp_path / "i.gz"), imgs)
    with pytest.raises(ValueError, match="magic"):
        TM.read_idx_labels(tmp_path / "i")


def _mnist_dir(tmp_path, n=40):
    imgs, lbls = _images(n, seed=1)
    TM.write_idx_images(tmp_path / "train-images-idx3-ubyte", imgs)
    TM.write_idx_labels(tmp_path / "train-labels-idx1-ubyte", lbls)
    return tmp_path


@pytest.mark.parametrize("binarize,flatten", [(True, True), (False, False)])
def test_mnist_fetcher_reads_idx_files_as_the_reference(tmp_path, binarize,
                                                        flatten):
    d = _mnist_dir(tmp_path)
    t = TF.MnistDataFetcher(binarize=binarize, flatten=flatten, data_dir=d)
    j = JF.MnistDataFetcher(binarize=binarize, flatten=flatten, data_dir=d)
    t.fetch(40)
    j.fetch(40)
    _same(t.next(), j.next())
    assert t.source == j.source == "idx"
    assert TF.MnistDataFetcher.real_data_available(d)
    assert not t.allow_download


def test_mnist_fetcher_default_dir_and_require_real(tmp_path, monkeypatch):
    assert TF.DEFAULT_BASE_DIR.name in (".dl4j_tpu",) or \
        str(TF.DEFAULT_BASE_DIR) == __import__("os").environ.get(
            "DL4J_TPU_DATA")
    f = TF.MnistDataFetcher(data_dir=tmp_path / "empty", require_real=True)
    with pytest.raises(FileNotFoundError, match="require_real"):
        f.fetch(1)


def test_mnist_iterator_batches_equal_the_reference(tmp_path):
    d = _mnist_dir(tmp_path)
    t = TI.MnistDataSetIterator(batch=16, data_dir=d)
    j = JI.MnistDataSetIterator(batch=16, data_dir=d)
    tb, jb = list(t), list(j)
    assert [b.num_examples() for b in tb] == [16, 16, 8]
    for a, b in zip(tb, jb):
        _same(a, b)
    assert t.total_examples() == 40 and t.input_columns() == 784
    assert t.total_outcomes() == 10 and t.batch() == 16 and t.cursor() == 40


def test_iris_and_digits_iterators_equal_the_reference():
    for tcls, jcls, kw in ((TI.IrisDataSetIterator, JI.IrisDataSetIterator,
                            {"batch": 40}),
                           (TI.DigitsDataSetIterator, JI.DigitsDataSetIterator,
                            {"batch": 500, "binarize": True})):
        tb, jb = list(tcls(**kw)), list(jcls(**kw))
        assert len(tb) == len(jb) > 1
        for a, b in zip(tb, jb):
            _same(a, b)
    # num_examples caps the stream
    it = TI.IrisDataSetIterator(batch=40, num_examples=100)
    assert [b.num_examples() for b in it] == [40, 40, 20]


def test_csv_iterator_and_vocabulary_labels(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("a,b,label\n1,2,cat\n3,4,dog\n5,6,cat\n7,8.5,bird\n")
    t = TI.CSVDataSetIterator(2, 0, p, label_col=-1, skip_header=True)
    j = JI.CSVDataSetIterator(2, 0, p, label_col=-1, skip_header=True)
    for a, b in zip(list(t), list(j)):
        _same(a, b)
    q = tmp_path / "n.csv"
    q.write_text("0,1.5,2\n1,2.5,3\n2,0.5,1\n")
    t = TF.CSVDataFetcher(q, label_col=0)
    j = JF.CSVDataFetcher(q, label_col=0)
    t.fetch(3)
    j.fetch(3)
    _same(t.next(), j.next())


def test_list_test_and_wrapper_iterators_equal_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((23, 16)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 23)]
    tds, jds = TD.DataSet(x, y), JF.DataSet(x, y)
    pairs = [
        (TI.ListDataSetIterator(tds, 5), JI.ListDataSetIterator(jds, 5)),
        (TI.TestDataSetIterator(tds, 7), JI.TestDataSetIterator(jds, 7)),
        (TI.MultipleEpochsIterator(3, TI.ListDataSetIterator(tds, 10)),
         JI.MultipleEpochsIterator(3, JI.ListDataSetIterator(jds, 10))),
        (TI.SamplingDataSetIterator(tds, 6, 4, seed=2),
         JI.SamplingDataSetIterator(jds, 6, 4, seed=2)),
        (TI.ReconstructionDataSetIterator(TI.ListDataSetIterator(tds, 9)),
         JI.ReconstructionDataSetIterator(JI.ListDataSetIterator(jds, 9))),
        (TI.MovingWindowDataSetIterator(8, tds, 2, 2),
         JI.MovingWindowDataSetIterator(8, jds, 2, 2)),
    ]
    for t, j in pairs:
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb) > 1, type(t).__name__
        for a, b in zip(tb, jb):
            _same(a, b)
        for m in ("total_examples", "input_columns", "total_outcomes",
                  "batch", "cursor"):
            assert getattr(t, m)() == getattr(j, m)(), (type(t).__name__, m)
    # the pre-processor hook
    it = TI.ListDataSetIterator(tds, 5)
    it.set_pre_processor(lambda d: d.binarize(0.0))
    assert set(np.unique(it.next().features)) <= {0.0, 1.0}


def test_scikit_learn_fetchers_import_it_only_when_they_load(monkeypatch):
    """Iris, digits and LFW import scikit-learn when they load, so a
    machine without it can still import the package and run MNIST from
    IDX files and the curves."""
    import builtins
    real = builtins.__import__

    def no_sklearn(name, *a, **kw):
        if name.startswith("sklearn"):
            raise ImportError("no sklearn here")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    for f in (TF.IrisDataFetcher(), TF.DigitsDataFetcher(),
              TF.LFWDataFetcher()):
        with pytest.raises(ImportError):
            f.fetch(1)
    c = TF.CurvesDataFetcher(n_examples=3)
    c.fetch(3)
    assert c.next().num_examples() == 3
