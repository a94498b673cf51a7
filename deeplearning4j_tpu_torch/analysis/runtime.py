"""Runtime enforcement: no host sync inside the port's hot loops.

Port of ``deeplearning4j_tpu/analysis/runtime.py``.  The static rules
catch the *patterns*; this module catches the *behavior*: hot loops (the
trainer's ``fit`` loop, the serving engine's decode segments) run under
:func:`hot_loop_guard`, and an operation that makes the host wait on the
device raises :class:`HostSyncError` at its call site instead of silently
draining the CUDA stream:

- a read of a device value (``aten::_local_scalar_dense``, behind
  ``.item()``, ``float(t)``, ``bool(t)`` and a 0-d tensor used as an
  index), ``nonzero``/``masked_select`` and boolean-mask indexing;
- a device-to-host copy (``.cpu()``, ``.tolist()``, ``.numpy()``);
- a blocking upload from pageable host memory (``torch.tensor(list,
  device="cuda")``, ``.to("cuda")`` of a pageable tensor).

An asynchronous copy from pinned memory (``non_blocking=True``, as
``datasets.prefetch_to_device`` makes it) stays allowed.  Deliberate
syncs sit inside :func:`allow_transfers` — the fences (a segment's
resolve, checkpoint, admission) are annotated, not exempted by luck.

Every transfer in torch is spelled out, so the reference's
``disallow_explicit``/``log_explicit`` levels act here as ``disallow``/
``log``: :func:`guard_mode` returns the reference's values, the guard
reads them so.  Opt out with ``DL4J_TPU_TRANSFER_GUARD=0`` (or
``off``/``allow``/...); ``log`` counts and logs offenders without
raising.

Scope: the reference's ``jax.transfer_guard`` is thread-local, and so is
this guard — a second engine resolving on another thread, an HTTP
handler or a prefill worker is never refused for the guarded thread's
rule.  On a GPU the detection is PyTorch's own sync check
(``torch.cuda.set_sync_debug_mode``), held at ``"warn"`` by a count
while any thread is guarded; the warning it raises on the syncing thread
becomes a :class:`HostSyncError` there only when that thread's innermost
scope is a guard (``warnings.showwarning`` is wrapped for the one
message; other warnings pass through).  It costs nothing per operation.
A caller's own setting is kept: the guard turns the check on only from
"default" (and then drops the warnings its switch causes on other
threads), leaves a caller's "warn" showing them and a caller's "error"
raising everywhere, fences included, and turns the check off again only
if it is still the guard's "warn".  Reading a CPU tensor is free (no
device waits), as the reference says of its CPU backend, so on the CPU
the guard is installed in the same places and refuses nothing;
``GUARDED_DEVICES`` is the seam that makes the CPU the guarded device,
for the guard's own CPU tests, which a ``TorchDispatchMode`` over the
same operations watches (thread-local by nature, one Python call per
ATen op; ``guard_probe.py`` measures it against the sync check on the
card).
"""

from __future__ import annotations

import contextlib
import logging
import os
import re
import threading
import warnings

ENV_FLAG = "DL4J_TPU_TRANSFER_GUARD"

_OFF_VALUES = {"0", "off", "false", "allow", "no", "disabled"}
_MODES = {"disallow", "log", "disallow_explicit", "log_explicit"}

#: device types whose syncs the guard refuses ("cpu" only in the tests)
GUARDED_DEVICES: tuple[str, ...] = ("cuda",)

#: the warning PyTorch's sync check issues on the thread that synced
_SYNC_WARNING = "called a synchronizing CUDA operation"
_SYNC_PATTERN = ".*" + re.escape(_SYNC_WARNING)

_log = logging.getLogger(__name__)
_tls = threading.local()
_lock = threading.Lock()
_counts = {"guarded": 0, "refused": 0, "logged": 0}
_debug_users = 0          # threads inside a sync-debug guard, all told
_debug_set = False        # the guard turned the check on from "default"
_prev_showwarning = None
_cuda_ok: bool | None = None


class HostSyncError(RuntimeError):
    """A host sync inside :func:`hot_loop_guard` (outside
    :func:`allow_transfers`)."""


def guard_mode() -> str | None:
    """The transfer-guard level for hot loops, or None when opted out."""
    raw = os.environ.get(ENV_FLAG, "").strip().lower()
    if raw in _OFF_VALUES:
        return None
    if raw in _MODES:
        return raw
    return "disallow"


def counts() -> dict:
    """Process-wide counts: guarded scopes entered, syncs refused, syncs
    logged (``log`` mode)."""
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        for k in _counts:
            _counts[k] = 0


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _on_sync(what: str) -> bool:
    """A sync happened on this thread: refuse, log or let it pass by the
    innermost scope.  True when it was logged."""
    st = _stack()
    level = st[-1] if st else None
    if level == "disallow":
        with _lock:
            _counts["refused"] += 1
        raise HostSyncError(
            f"host sync inside hot_loop_guard(): {what} — return the device "
            "value and read it at a fence under allow_transfers() (opt "
            f"out: {ENV_FLAG}=0)")
    if level == "log":
        with _lock:
            _counts["logged"] += 1
        _log.warning("host sync inside hot_loop_guard() (log mode): %s", what)
        return True
    return False


# ------------------------------------------------------------- sync debug
def _cuda_available() -> bool:
    global _cuda_ok
    if _cuda_ok is None:
        import torch

        _cuda_ok = bool(torch.cuda.is_available())
    return _cuda_ok


def _showwarning(message, category, filename, lineno, file=None, line=None):
    if _SYNC_WARNING in str(message):
        if _on_sync(f"a synchronizing CUDA operation at {filename}:{lineno}") \
                or _debug_set:       # logged, or only the guard's switch
            return
    _prev_showwarning(message, category, filename, lineno, file, line)


def _assert_hook() -> None:
    """Put (back) the filter that shows every sync warning and the
    ``showwarning`` wrapper that routes it — a ``catch_warnings`` exit
    elsewhere restores the lists it saved.  Caller holds ``_lock``."""
    global _prev_showwarning
    head = warnings.filters[0] if warnings.filters else None
    if not (head and head[0] == "always"
            and getattr(head[1], "pattern", None) == _SYNC_PATTERN):
        warnings.filterwarnings("always", message=_SYNC_PATTERN,
                                category=UserWarning)
    if warnings.showwarning is not _showwarning:
        _prev_showwarning = warnings.showwarning
        warnings.showwarning = _showwarning


def _debug_enter() -> None:
    """Count a guarded thread in; turn the check on if it is off (also
    when a caller turned it off while another thread was guarded)."""
    global _debug_users, _debug_set
    import torch

    with _lock:
        _assert_hook()
        _debug_users += 1
        if torch.cuda.get_sync_debug_mode() == 0:
            torch.cuda.set_sync_debug_mode("warn")
            _debug_set = True


def _debug_exit() -> None:
    """Count a guarded thread out; the last one turns the check off if
    the guard turned it on and it is still at the guard's "warn"."""
    global _debug_users, _debug_set
    import torch

    with _lock:
        _debug_users -= 1
        if _debug_users == 0 and _debug_set:
            _debug_set = False
            if torch.cuda.get_sync_debug_mode() == 1:
                torch.cuda.set_sync_debug_mode(0)


# --------------------------------------------------------- dispatch mode
_SCALAR_READS = frozenset({"aten::_local_scalar_dense", "aten::nonzero",
                           "aten::nonzero_static", "aten::is_nonzero",
                           "aten::masked_select"})
_INDEXING = frozenset({"aten::index", "aten::index_put",
                       "aten::index_put_", "aten::_index_put_impl_"})


def _dispatch_sync(func, args, kwargs, devices) -> str | None:
    """What of the host waits in one ATen call, or None."""
    import torch

    name = func._schema.name
    first = args[0] if args else None
    on = (lambda t: torch.is_tensor(t) and t.device.type in devices)
    if name in _SCALAR_READS:
        return f"{name} of a {first.device.type} tensor" if on(first) \
            else None
    if name in _INDEXING and on(first) and any(
            torch.is_tensor(t) and t.dtype in (torch.bool, torch.uint8)
            for t in (args[1] if len(args) > 1 else ()) if t is not None):
        return f"{name} with a boolean mask"
    if name == "aten::_to_copy" and torch.is_tensor(first):
        dst = kwargs.get("device") or first.device
        src, non_blocking = first, kwargs.get("non_blocking", False)
    elif name == "aten::copy_" and len(args) > 1 and torch.is_tensor(args[1]):
        dst, src = first.device, args[1]
        non_blocking = args[2] if len(args) > 2 else kwargs.get(
            "non_blocking", False)
    else:
        return None
    dst = torch.device(dst)
    if src.device.type == dst.type:
        return None
    if src.device.type in devices and dst.type == "cpu":
        return f"{name}: a copy to the host"
    if dst.type in devices and src.device.type == "cpu" and not (
            non_blocking and src.is_pinned()):
        return f"{name}: a blocking upload from pageable memory"
    return None


_refusal_cls = None


def _refusal_mode(devices):
    """A ``TorchDispatchMode`` refusing the syncs of ``devices`` (the
    class is built once, at the first guard that needs it)."""
    global _refusal_cls
    if _refusal_cls is None:
        from torch.utils._python_dispatch import TorchDispatchMode

        class SyncRefusal(TorchDispatchMode):
            def __init__(self, watched):
                super().__init__()
                self.watched = watched

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                what = _dispatch_sync(func, args, kwargs, self.watched)
                if what is not None:
                    _on_sync(what)
                return func(*args, **kwargs)

        _refusal_cls = SyncRefusal
    return _refusal_cls(devices)


def _mechanisms() -> tuple[bool, frozenset]:
    """(use the sync-debug check, device types a dispatch mode watches)."""
    return ("cuda" in GUARDED_DEVICES and _cuda_available(),
            frozenset(d for d in GUARDED_DEVICES if d != "cuda"))


# -------------------------------------------------------------- contexts
@contextlib.contextmanager
def hot_loop_guard():
    """Run a hot loop under the configured transfer guard, on this thread.

    No-op (and no torch import) when opted out, so host-only tooling can
    wrap loops unconditionally.
    """
    mode = guard_mode()
    if mode is None:
        yield None
        return
    st = _stack()
    st.append(mode.removesuffix("_explicit"))
    with _lock:
        _counts["guarded"] += 1
    debug, watched = _mechanisms()
    mode_cm = _refusal_mode(watched) if watched and not getattr(
        _tls, "watching", False) else None
    try:
        if debug:
            _debug_enter()
        try:
            if mode_cm is None:
                yield mode
            else:
                _tls.watching = True
                try:
                    with mode_cm:
                        yield mode
                finally:
                    _tls.watching = False
        finally:
            if debug:
                _debug_exit()
    finally:
        st.pop()


@contextlib.contextmanager
def allow_transfers():
    """Explicit sync point inside a guarded region (checkpoint fences,
    end-of-run parameter pulls, a decode segment's resolve): re-allows
    host syncs for the scope on this thread, making 'this code is ALLOWED
    to sync' a visible annotation."""
    st = _stack()
    st.append("allow")
    try:
        yield
    finally:
        st.pop()
