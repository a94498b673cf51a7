"""Shared helpers of the port (reference: ``util/*``, ``berkeley/*``).

Port of ``deeplearning4j_tpu/utils``, name for name its ``__all__``:
host counters, the misc utilities and the string grid, copied; the
Viterbi decoder, whose recursion runs on the device; parameter-tree
arithmetic (``tree_math``) and the autodiff transforms (``autodiff``).
"""

from . import counters, misc, tree_math, viterbi
from .counters import Counter, CounterMap, Index
from .misc import DiskBasedQueue, SummaryStatistics
from .viterbi import Viterbi, viterbi_decode

__all__ = ["counters", "misc", "tree_math", "viterbi",
           "Counter", "CounterMap", "Index",
           "DiskBasedQueue", "SummaryStatistics",
           "Viterbi", "viterbi_decode"]
