"""Dataset fetchers.

Port of ``deeplearning4j_tpu/datasets/fetchers.py`` (host-side numpy):
``BaseDataFetcher`` cursor/batch bookkeeping, MNIST from IDX files,
Iris, digits, curves, LFW and CSV.

Sourcing is offline-first: Iris, the 8x8 digits corpus and LFW come from
scikit-learn (imported when a fetcher loads, so a machine without it
raises ``ImportError`` there and nowhere else); full MNIST reads IDX
files under ``$DL4J_TPU_DATA/mnist`` (default ``~/.dl4j_tpu/mnist``) and
otherwise falls back, loudly, to the digits upscaled to 28x28.  Nothing
is downloaded unless ``allow_download=True`` is passed.  The curves are
synthesized with numpy and need nothing.
"""

from __future__ import annotations

import os
import urllib.request
from pathlib import Path

import numpy as np

from .dataset import DataSet, to_outcome_matrix
from .mnist_idx import read_idx_images, read_idx_labels

DEFAULT_BASE_DIR = Path(os.environ.get("DL4J_TPU_DATA", Path.home() / ".dl4j_tpu"))


class BaseDataFetcher:
    """Cursor/batch bookkeeping (``BaseDataFetcher.java``): subclasses load
    arrays once; ``fetch(num)`` advances a cursor and exposes ``cur`` as a
    DataSet."""

    def __init__(self):
        self.cursor = 0
        self.num_outcomes = 0
        self.input_columns = 0
        self.total_examples_ = 0
        self.cur: DataSet | None = None
        self._features: np.ndarray | None = None
        self._labels: np.ndarray | None = None

    # subclass hook
    def _load(self) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _ensure_loaded(self):
        if self._features is None:
            f, l = self._load()
            self._features = np.asarray(f, dtype=np.float32)
            self._labels = np.asarray(l, dtype=np.float32)
            self.total_examples_ = self._features.shape[0]
            self.input_columns = int(np.prod(self._features.shape[1:]))
            self.num_outcomes = self._labels.shape[-1]

    def has_more(self) -> bool:
        self._ensure_loaded()
        return self.cursor < self.total_examples_

    def fetch(self, num: int) -> None:
        self._ensure_loaded()
        if not self.has_more():
            raise StopIteration("fetcher exhausted")
        end = min(self.cursor + num, self.total_examples_)
        self.cur = DataSet(self._features[self.cursor:end], self._labels[self.cursor:end])
        self.cursor = end

    def next(self) -> DataSet:
        return self.cur

    def reset(self) -> None:
        self.cursor = 0

    def total_examples(self) -> int:
        self._ensure_loaded()
        return self.total_examples_


class IrisDataFetcher(BaseDataFetcher):
    """Iris, 150 examples, 4 features, 3 classes (``IrisDataFetcher`` +
    ``base/IrisUtils.java``).  Sourced from scikit-learn's bundled copy."""

    NUM_EXAMPLES = 150

    def _load(self):
        from sklearn.datasets import load_iris
        d = load_iris()
        return d.data, to_outcome_matrix(d.target, 3)


class DigitsDataFetcher(BaseDataFetcher):
    """8x8 handwritten digits (1,797 examples, 10 classes) — the offline
    MNIST-class corpus bundled with scikit-learn; used by tests as the fast
    stand-in for full MNIST."""

    def __init__(self, binarize: bool = False, flatten: bool = True):
        super().__init__()
        self.binarize = binarize
        self.flatten = flatten

    def _load(self):
        from sklearn.datasets import load_digits
        d = load_digits()
        x = d.data / 16.0 if self.flatten else d.images[..., None] / 16.0
        if self.binarize:
            x = (x > 0.5).astype(np.float32)
        return x, to_outcome_matrix(d.target, 10)


class MnistDataFetcher(BaseDataFetcher):
    """Full MNIST via local IDX files (``MnistDataFetcher.java:21-80``,
    ``base/MnistFetcher.java:30``).

    Search order for ``train-images-idx3-ubyte[.gz]`` etc.: a vendored
    fixture beside this module (``datasets/fixtures/mnist``), then
    ``data_dir``;
    attempts download when ``allow_download`` (no egress here, so default
    False).  Otherwise falls back to the bundled digits corpus upscaled to
    28x28 so MNIST-shaped pipelines still run offline — the fallback is
    LOUD: ``source`` is set to ``"digits_fallback"``, a warning is emitted,
    and ``require_real=True`` turns it into an error so a test asserting
    on real pixels can never silently pass on fake ones.
    """

    NUM_EXAMPLES = 60000
    FIXTURE_DIR = Path(__file__).parent / "fixtures" / "mnist"
    URLS = {
        "train-images-idx3-ubyte.gz": "https://ossci-datasets.s3.amazonaws.com/mnist/train-images-idx3-ubyte.gz",
        "train-labels-idx1-ubyte.gz": "https://ossci-datasets.s3.amazonaws.com/mnist/train-labels-idx1-ubyte.gz",
        "t10k-images-idx3-ubyte.gz": "https://ossci-datasets.s3.amazonaws.com/mnist/t10k-images-idx3-ubyte.gz",
        "t10k-labels-idx1-ubyte.gz": "https://ossci-datasets.s3.amazonaws.com/mnist/t10k-labels-idx1-ubyte.gz",
    }

    def __init__(self, binarize: bool = True, train: bool = True,
                 data_dir: Path | str | None = None, allow_download: bool = False,
                 flatten: bool = True, require_real: bool = False):
        super().__init__()
        self.binarize = binarize
        self.train = train
        self.data_dir = Path(data_dir) if data_dir else DEFAULT_BASE_DIR / "mnist"
        # an explicitly-passed data_dir must win over the vendored fixture
        self._search_dirs = ((self.data_dir, self.FIXTURE_DIR) if data_dir
                             else (self.FIXTURE_DIR, self.data_dir))
        self.allow_download = allow_download
        self.flatten = flatten
        self.require_real = require_real
        self.source: str | None = None   # "idx" | "digits_fallback" after load

    @classmethod
    def real_data_available(cls, data_dir: Path | str | None = None) -> bool:
        """True when real IDX files are reachable (fixture or data_dir)."""
        f = cls(train=True, data_dir=data_dir)
        return f._find("train-images-idx3-ubyte") is not None

    def _find(self, stem: str) -> Path | None:
        for base in self._search_dirs:
            for name in (stem, stem + ".gz"):
                p = base / name
                if p.exists():
                    return p
        return None

    def _maybe_download(self, stem: str) -> Path | None:
        if not self.allow_download:
            return None
        self.data_dir.mkdir(parents=True, exist_ok=True)
        url = self.URLS[stem + ".gz"]
        dest = self.data_dir / (stem + ".gz")
        try:
            urllib.request.urlretrieve(url, dest)  # noqa: S310
            return dest
        except Exception:
            return None

    def _load(self):
        img_stem = ("train-images-idx3-ubyte" if self.train else "t10k-images-idx3-ubyte")
        lbl_stem = ("train-labels-idx1-ubyte" if self.train else "t10k-labels-idx1-ubyte")
        img_path = self._find(img_stem) or self._maybe_download(img_stem)
        lbl_path = self._find(lbl_stem) or self._maybe_download(lbl_stem)
        if img_path and lbl_path:
            images = read_idx_images(img_path)  # (n, 28, 28) uint8
            labels = read_idx_labels(lbl_path)
            x = images.astype(np.float32) / 255.0
            self.source = "idx"
        else:
            if self.require_real:
                raise FileNotFoundError(
                    f"real MNIST IDX files not found (looked in "
                    f"{self.FIXTURE_DIR} and {self.data_dir}) and "
                    "require_real=True; place the IDX files in the data "
                    "directory ($DL4J_TPU_DATA/mnist)")
            # Offline fallback: digits upscaled 8x8 -> 28x28 (nearest).
            import warnings
            warnings.warn(
                "MnistDataFetcher: real IDX files absent — falling back to "
                "sklearn 8x8 digits upscaled to 28x28 (NOT real MNIST "
                "pixels); place the IDX files in $DL4J_TPU_DATA/mnist",
                stacklevel=2)
            self.source = "digits_fallback"
            from sklearn.datasets import load_digits
            d = load_digits()
            imgs = d.images / 16.0
            reps = 28 // 8 + 1
            x = np.repeat(np.repeat(imgs, reps, axis=1), reps, axis=2)[:, :28, :28]
            x = x.astype(np.float32)
            labels = d.target
        if self.binarize:
            x = (x > 0.5).astype(np.float32)
        if self.flatten:
            x = x.reshape(x.shape[0], -1)
        else:
            x = x[..., None]  # NHWC
        return x, to_outcome_matrix(labels, 10)


class CurvesDataFetcher(BaseDataFetcher):
    """Curves dataset (``datasets/fetchers/CurvesDataFetcher.java``): 28x28
    grayscale images of smooth random curves, the classic deep-autoencoder
    pretraining corpus.

    The reference downloads a serialized DataSet from S3
    (``CURVES_URL``); this environment has no egress, so the curves are
    synthesized directly — each image rasterizes a random cubic Bezier
    curve (4 control points, deterministic per ``seed``), which is the
    generative process behind the original corpus.  Labels are the images
    themselves (reconstruction target), matching its autoencoder use.
    """

    SIDE = 28

    def __init__(self, n_examples: int = 1000, seed: int = 0):
        super().__init__()
        self.n_examples = n_examples
        self.seed = seed

    def _load(self):
        rng = np.random.default_rng(self.seed)
        side = self.SIDE
        n_steps = 200
        t = np.linspace(0.0, 1.0, n_steps)[:, None]            # (S, 1)
        # Bernstein basis for a cubic Bezier
        basis = np.concatenate([(1 - t) ** 3, 3 * (1 - t) ** 2 * t,
                                3 * (1 - t) * t ** 2, t ** 3], axis=1)  # (S, 4)
        imgs = np.zeros((self.n_examples, side, side), np.float32)
        ctrl = rng.uniform(2, side - 3, (self.n_examples, 4, 2))  # (N, 4, 2)
        pts = np.einsum("sk,nkd->nsd", basis, ctrl)               # (N, S, 2)
        ij = np.rint(pts).astype(int)
        n_idx = np.repeat(np.arange(self.n_examples), n_steps)
        imgs[n_idx, ij[..., 1].ravel(), ij[..., 0].ravel()] = 1.0
        flat = imgs.reshape(self.n_examples, side * side)
        return flat, flat.copy()      # reconstruction corpus: labels = inputs


class LFWDataFetcher(BaseDataFetcher):
    """Labeled Faces in the Wild (``LFWDataFetcher`` + ``base/LFWLoader.java:31``).

    Uses scikit-learn's cached copy when present on disk; cannot download in
    this environment, so raises a clear error otherwise.
    """

    def __init__(self, min_faces_per_person: int = 70, resize: float = 0.4):
        super().__init__()
        self.min_faces_per_person = min_faces_per_person
        self.resize = resize

    def _load(self):
        from sklearn.datasets import fetch_lfw_people
        try:
            d = fetch_lfw_people(min_faces_per_person=self.min_faces_per_person,
                                 resize=self.resize, download_if_missing=False)
        except OSError as e:
            raise RuntimeError(
                "LFW data not cached locally and downloads are disabled in "
                "this environment; place the scikit-learn LFW cache under "
                "~/scikit_learn_data to use LFWDataFetcher") from e
        n_classes = int(d.target.max()) + 1
        return d.data / 255.0, to_outcome_matrix(d.target, n_classes)


class CSVDataFetcher(BaseDataFetcher):
    """CSV ingestion (``CSVDataFetcher``): label column index + feature
    columns; non-numeric labels are vocabulary-mapped."""

    def __init__(self, path: Path | str, label_col: int = -1, skip_header: bool = False,
                 delimiter: str = ","):
        super().__init__()
        self.path = Path(path)
        self.label_col = label_col
        self.skip_header = skip_header
        self.delimiter = delimiter

    def _load(self):
        rows = []
        with open(self.path) as f:
            lines = f.read().strip().splitlines()
        if self.skip_header:
            lines = lines[1:]
        for line in lines:
            if line.strip():
                rows.append(line.strip().split(self.delimiter))
        ncol = len(rows[0])
        lc = self.label_col % ncol
        raw_labels = [r[lc] for r in rows]
        feats = self._parse_features(lines, rows, ncol, lc)
        try:
            label_idx = np.array([int(float(v)) for v in raw_labels])
        except ValueError:
            vocab = {v: i for i, v in enumerate(sorted(set(raw_labels)))}
            label_idx = np.array([vocab[v] for v in raw_labels])
        return feats, to_outcome_matrix(label_idx, int(label_idx.max()) + 1)

    def _parse_features(self, lines, rows, ncol, lc) -> np.ndarray:
        """Feature columns as float32; native C parser fast path when the
        WHOLE grid is numeric (labels included), Python otherwise."""
        if self.delimiter == ",":
            try:
                from ..native import runtime as native_rt
                full = native_rt.parse_csv_floats("\n".join(lines) + "\n", ncol)
            except ImportError:
                full = None
            if full is not None and full.shape[0] == len(rows):
                return np.delete(full, lc, axis=1).astype(np.float32)
        return np.array([[float(v) for j, v in enumerate(r) if j != lc]
                         for r in rows], dtype=np.float32)
