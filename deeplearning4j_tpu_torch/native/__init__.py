"""Native C++ host runtime of the port (optional acceleration).

Port of ``deeplearning4j_tpu/native``: C++ implementations of the
host-bound hot paths that feed the device — tokenize+count vocab
building, skip-gram pair generation, GloVe's co-occurrence counts and
the svmlight / CSV parsers — built from the port's own copy of
``src/host_runtime.cpp`` into ``deeplearning4j_tpu_torch/_build/``
(``build.py``) and bound via ctypes (``runtime.py``).  Every call site
falls back to pure Python when the library is absent; import of this
package never fails just because the library isn't built.
"""

from . import runtime

__all__ = ["runtime"]
