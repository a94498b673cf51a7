"""Datasets of the port: the ``DataSet`` container, the fetchers (MNIST
IDX files, Iris, digits, curves, LFW, CSV), the dataset iterators and the
double-buffered host-to-device feed (``prefetch_to_device``), the
SVMLight reader/writer (native parse first) and the record readers
(``records``: CSV, line, in-memory and image readers behind
``RecordReaderDataSetIterator``)."""

from .dataset import DataSet, to_outcome_matrix
from .fetchers import (
    BaseDataFetcher,
    CSVDataFetcher,
    CurvesDataFetcher,
    DigitsDataFetcher,
    IrisDataFetcher,
    LFWDataFetcher,
    MnistDataFetcher,
)
from .svmlight import (
    SVMLightDataFetcher,
    SVMLightDataSetIterator,
    load_svmlight,
    parse_svmlight_line,
    save_svmlight,
)
from .iterator import (
    BaseDatasetIterator,
    CSVDataSetIterator,
    CurvesDataSetIterator,
    DataSetIterator,
    DigitsDataSetIterator,
    IrisDataSetIterator,
    ListDataSetIterator,
    MnistDataSetIterator,
    MovingWindowDataSetIterator,
    MultipleEpochsIterator,
    ReconstructionDataSetIterator,
    SamplingDataSetIterator,
    TestDataSetIterator,
    prefetch_to_device,
)

__all__ = [
    "DataSet", "to_outcome_matrix", "prefetch_to_device",
    "BaseDataFetcher", "CSVDataFetcher", "CurvesDataFetcher",
    "DigitsDataFetcher", "IrisDataFetcher", "LFWDataFetcher",
    "MnistDataFetcher",
    "BaseDatasetIterator", "CSVDataSetIterator", "CurvesDataSetIterator",
    "DataSetIterator", "DigitsDataSetIterator", "IrisDataSetIterator",
    "ListDataSetIterator", "MnistDataSetIterator",
    "MovingWindowDataSetIterator", "MultipleEpochsIterator",
    "ReconstructionDataSetIterator", "SamplingDataSetIterator",
    "TestDataSetIterator",
    "SVMLightDataFetcher", "SVMLightDataSetIterator", "load_svmlight",
    "parse_svmlight_line", "save_svmlight",
]
