"""Shared observability state: the process-wide enable flag.

Port of ``deeplearning4j_tpu/observability/core.py``.  When observability
is disabled, instrumented hot paths do no per-step Python allocation:
``span()`` hands back the one shared :data:`NOOP_SPAN`, registry mutators
return before taking their lock, and call sites gate their
``time.perf_counter()`` reads on :func:`enabled`.

Default is on; ``DL4J_TPU_OBS=0`` (or :func:`disable`) turns it off.
"""

from __future__ import annotations

import os

_ENABLED: bool = os.environ.get("DL4J_TPU_OBS", "1") not in ("0", "false",
                                                              "off")


def enabled() -> bool:
    """Is observability collection on?  Safe to call per step."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


class _NoopSpan:
    """The do-nothing context manager every disabled ``span()``/``time()``
    call returns: one instance for the process, so the disabled path
    allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:  # matches Span.set
        pass


NOOP_SPAN = _NoopSpan()
