"""A CPU check of the port's hot-loop rule: no host sync between fences.

On the CPU nothing waits for a device, so :class:`NoHostSync` refuses
the operations that would wait on the GPU: reading a value to the host
(``aten::_local_scalar_dense``, behind ``.item()``, ``bool()`` and a 0-d
tensor used as an index, which ATen reads on the host), ``nonzero``,
``masked_select``, and indexing with a boolean mask (which runs
``nonzero`` inside the kernel).  It sees the operations that the C++
side runs as well as the Python ones.  Copies to the host
(``.cpu()``, ``.numpy()``) are no-ops on CPU tensors, so the tests also
replace those methods.  On the GPU, ``torch.cuda.set_sync_debug_mode``
checks the same (``tests/test_torch_cuda.py``).
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

SYNCS = frozenset({"aten::_local_scalar_dense", "aten::nonzero",
                   "aten::nonzero_static", "aten::is_nonzero",
                   "aten::masked_select"})
INDEXING = frozenset({"aten::index", "aten::index_put",
                      "aten::index_put_", "aten::_index_put_impl_"})
MASKS = (torch.bool, torch.uint8)


class NoHostSync(TorchDispatchMode):
    """Raise ``AssertionError`` on an operation that syncs with the
    host; ``seen`` counts the operations let through."""

    def __init__(self):
        super().__init__()
        self.seen = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in SYNCS or (name in INDEXING and any(
                t is not None and t.dtype in MASKS for t in args[1])):
            raise AssertionError(f"host sync inside the hot loop: {name}")
        self.seen += 1
        return func(*args, **(kwargs or {}))
