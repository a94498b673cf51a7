"""Runtime race detection: instrumented locks + Eraser-style write checks.

Port of ``deeplearning4j_tpu/analysis/lockguard.py``: a copy over the
port's ``observability.METRICS``.  It patches ``threading.Lock``/
``RLock`` process-wide, so this guard and the JAX package's must never be
installed at the same time: :meth:`LockGuard.install` refuses when the
factories are already patched.

The static concurrency rules (LK01-LK03, TH01) reason about the *code*;
this module watches the *execution*.  ``LockGuard.install()`` swaps
``threading.Lock``/``threading.RLock`` for wrappers that track, per
thread, the stack of locks currently held:

- every ``acquire`` while other locks are held adds edges to a runtime
  lock-order graph; an acquisition that closes a cycle (thread 1 takes
  A then B, thread 2 takes B then A) is reported as a **lock-order
  inversion** — the deadlock is detected even when the interleaving that
  would actually wedge never happens in this run;
- ``watch(obj)`` applies the Eraser lockset algorithm (Savage et al.,
  SOSP '97) to an object's attribute writes: after an attribute has been
  written by two or more threads, the intersection of the locksets held
  at each write must stay non-empty — an empty intersection means no
  single lock consistently guards the field and is reported as an
  **unguarded write**.

Opt-in only: nothing is patched at import.  Tests use the
``lockguard_active()`` context (the port's tests apply it through their
own fixtures: ``tests/conftest.py``'s marker installs the JAX package's
guard); a program that honours ``DL4J_TPU_LOCKGUARD=1``
(:func:`enabled_from_env`) installs it for the whole process.
``chip_smoke.py`` installs it around the disaggregated tier's phase on
the card.

Known limits (inherited from Eraser): the initialization handoff —
object built on one thread, then published to a worker via
``Thread.start()``'s happens-before edge — looks like an unguarded
shared write to a pure lockset algorithm.  ``watch()`` is therefore
applied *after* the handoff point (e.g. after ``engine.start()``), which
makes the worker the exclusive first owner and keeps the signal clean.
Locks created before ``install()`` (or via ``from threading import
Lock``) are not instrumented; the serving/training stack constructs its
locks lazily enough that marker-scoped installs see them.
"""

from __future__ import annotations

import _thread
import contextlib
import dataclasses
import itertools
import os
import sys
import threading

ENV_LOCKGUARD = "DL4J_TPU_LOCKGUARD"

# the interpreter's own factories, whatever is patched when this imports
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = threading._CRLock or threading._PyRLock

_ON_VALUES = {"1", "on", "true", "yes", "enabled"}


def enabled_from_env() -> bool:
    """True when ``DL4J_TPU_LOCKGUARD`` asks for a process-wide lockguard."""
    return os.environ.get(ENV_LOCKGUARD, "").strip().lower() in _ON_VALUES


@dataclasses.dataclass(frozen=True)
class Violation:
    """One runtime finding — a lock-order cycle or an unguarded write."""

    kind: str                    # "lock-order" | "unguarded-write"
    message: str
    thread: str                  # name of the thread that completed it
    details: tuple = ()          # cycle lock labels / (class, attr)

    def __str__(self) -> str:    # report/assert readability
        return f"[{self.kind}] {self.message} (thread={self.thread})"


def _creation_site() -> str:
    """file:line of the frame that called the lock factory (labels)."""
    f = sys._getframe(2)
    skip = (__file__, threading.__file__)
    while f is not None and f.f_code.co_filename in skip:
        f = f.f_back
    if f is None:
        return "<unknown>"
    fn = f.f_code.co_filename
    for marker in ("/deeplearning4j_tpu_torch/", "/deeplearning4j_tpu/",
                   "/tests/", "/chip_smoke.py"):
        i = fn.find(marker)
        if i >= 0:
            fn = fn[i + 1:]
            break
    return f"{fn}:{f.f_lineno}"


_LOCK_IDS = itertools.count(1)


class _GuardedLock:
    """Instrumented ``threading.Lock``.

    Deliberately does NOT expose ``_release_save``/``_acquire_restore``:
    ``threading.Condition`` then falls back to its plain-lock defaults,
    which route through :meth:`acquire`/:meth:`release` — condition
    waits stay visible to the hold tracker for free.
    """

    __slots__ = ("_inner", "_guard", "_id", "_label")

    _reentrant = False

    def __init__(self, guard: "LockGuard", inner, label: str):
        self._inner = inner
        self._guard = guard
        self._id = next(_LOCK_IDS)
        self._label = label

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:  # failed non-blocking probes hold nothing — not recorded
            self._guard._note_acquire(self)
        return ok

    def release(self) -> None:
        self._guard._note_release(self)
        self._inner.release()

    def locked(self) -> bool:
        probe = getattr(self._inner, "locked", None)
        return probe() if probe is not None else False

    def __enter__(self) -> "_GuardedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        kind = "RLock" if self._reentrant else "Lock"
        return f"<lockguard.{kind} #{self._id} from {self._label}>"


class _GuardedRLock(_GuardedLock):
    """Instrumented ``threading.RLock``.

    Unlike the plain wrapper it DOES delegate the Condition protocol
    (``_release_save`` fully releases, ``_acquire_restore`` re-acquires
    at the saved count) so ``Condition.wait`` on a reentrant lock keeps
    the hold stack truthful instead of corrupting the count.
    """

    __slots__ = ()

    _reentrant = True

    def _release_save(self):
        count = self._guard._note_release_all(self)
        state = self._inner._release_save()
        return (count, state)

    def _acquire_restore(self, saved) -> None:
        count, state = saved
        self._inner._acquire_restore(state)
        self._guard._note_acquire(self, restore_count=count)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


class LockGuard:
    """The detector: lock-order graph + Eraser lockset state.

    All internal metadata is protected by an ORIGINAL (pre-patch) lock so
    the guard never traffics through its own instrumentation.
    """

    def __init__(self) -> None:
        self._meta = _REAL_LOCK()
        self._tls = threading.local()
        self._installed = False
        self._edges: dict[int, dict[int, str]] = {}   # A -> {B: site}
        self._labels: dict[int, str] = {}
        self._violations: list[Violation] = []
        self._seen_cycles: set[frozenset] = set()
        # Eraser state per (object id, attr): [owner_ident, writers set,
        # candidate lock-id set | None while exclusive, reported flag]
        self._eraser: dict[tuple[int, str], list] = {}
        self._watched: dict[int, object] = {}   # id -> obj (keeps it alive)
        self._made = 0                          # locks built while installed
        self._watch_classes: dict[type, type] = {}

    # ------------------------------------------------------------ install
    def install(self) -> "LockGuard":
        """Patch ``threading.Lock``/``RLock`` (idempotent).

        ``queue``, ``threading.Condition`` and ``threading.Event`` all
        resolve these names from the ``threading`` module at call time,
        so their internal locks come back instrumented too.
        """
        with self._meta:
            if self._installed:
                return self
            if threading.Lock is not _REAL_LOCK \
                    or threading.RLock.__module__ != "threading":
                raise RuntimeError(
                    "threading.Lock/RLock are already patched (the JAX "
                    "package's lockguard?): two lock instrumentations must "
                    "not be installed at once")
            self._saved = (threading.Lock, threading.RLock)
            self._installed = True
        guard = self

        def make_lock():
            guard._made += 1
            return _GuardedLock(guard, _REAL_LOCK(), _creation_site())

        def make_rlock():
            guard._made += 1
            return _GuardedRLock(guard, _REAL_RLOCK(), _creation_site())

        threading.Lock = make_lock
        threading.RLock = make_rlock
        return self

    def uninstall(self) -> None:
        """Restore the real factories; live wrapped locks keep working."""
        with self._meta:
            if not self._installed:
                return
            self._installed = False
        threading.Lock, threading.RLock = self._saved
        for obj in list(self._watched.values()):
            self.unwatch(obj)

    @property
    def installed(self) -> bool:
        return self._installed

    def instrumented(self) -> int:
        """Locks and RLocks built through the patched factories (what the
        guard saw; a Condition or queue counts its inner lock)."""
        return self._made

    # ------------------------------------------------------- hold stacks
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []   # entries: [lock, count]
        return st

    def _held_ids(self) -> frozenset:
        return frozenset(e[0]._id for e in self._stack())

    def _note_acquire(self, lock: _GuardedLock,
                      restore_count: int = 1) -> None:
        stack = self._stack()
        if lock._reentrant:
            for entry in stack:
                if entry[0] is lock:     # re-entry: no new edges
                    entry[1] += 1
                    return
        held = [e[0] for e in stack]
        stack.append([lock, restore_count])
        if not held:
            return
        site = _creation_site()
        with self._meta:
            self._labels.setdefault(lock._id, lock._label)
            for h in held:
                self._labels.setdefault(h._id, h._label)
                self._edges.setdefault(h._id, {}).setdefault(lock._id, site)
            self._check_cycle(lock._id)

    def _note_release(self, lock: _GuardedLock) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is lock:
                stack[i][1] -= 1
                if stack[i][1] <= 0:
                    del stack[i]
                return
        # release of a lock acquired before install/on another thread —
        # nothing tracked, nothing to unwind

    def _note_release_all(self, lock: _GuardedLock) -> int:
        """Condition.wait on an RLock: drop every held count at once."""
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is lock:
                count = stack[i][1]
                del stack[i]
                return count
        return 1

    # ------------------------------------------------------- order graph
    def _check_cycle(self, start: int) -> None:
        """DFS from ``start``; a path back to it is an inversion cycle.

        Caller holds ``self._meta``.
        """
        path: list[int] = [start]
        on_path = {start}

        def dfs(node: int) -> bool:
            for nxt in self._edges.get(node, ()):
                if nxt == start:
                    return True
                if nxt in on_path:
                    continue
                path.append(nxt)
                on_path.add(nxt)
                if dfs(nxt):
                    return True
                on_path.discard(path.pop())
            return False

        if not dfs(start):
            return
        key = frozenset(path)
        if key in self._seen_cycles:
            return
        self._seen_cycles.add(key)
        labels = tuple(self._labels.get(n, f"#{n}") for n in path)
        order = " -> ".join(labels + (labels[0],))
        self._violations.append(Violation(
            kind="lock-order",
            message=(f"lock-order inversion: {order} — two threads acquire "
                     f"these locks in opposite orders; under the wrong "
                     f"interleaving both block forever"),
            thread=threading.current_thread().name,
            details=labels))

    # ------------------------------------------------------------ eraser
    def watch(self, obj) -> object:
        """Track every attribute write on ``obj`` with the lockset rule.

        Swaps ``obj.__class__`` for a generated subclass whose
        ``__setattr__`` records (thread, lockset) before delegating, so
        there is zero cost for unwatched objects.  Apply AFTER any
        single-threaded initialization handoff (see module docstring).
        """
        cls = type(obj)
        if cls in self._watch_classes.values():
            return obj               # already watched
        sub = self._watch_classes.get(cls)
        if sub is None:
            guard = self

            def __setattr__(s, name, value):
                if not name.startswith("__"):   # class swap, machinery
                    guard._note_write(s, name)
                cls.__setattr__(s, name, value)

            sub = type(f"_Watched_{cls.__name__}", (cls,),
                       {"__setattr__": __setattr__, "__slots__": ()})
            self._watch_classes[cls] = sub
        obj.__class__ = sub
        self._watched[id(obj)] = obj
        return obj

    def unwatch(self, obj) -> None:
        if type(obj) in self._watch_classes.values():
            obj.__class__ = type(obj).__mro__[1]
        self._watched.pop(id(obj), None)

    def _note_write(self, obj, attr: str) -> None:
        ident = threading.get_ident()
        held = self._held_ids()
        with self._meta:
            key = (id(obj), attr)
            st = self._eraser.get(key)
            if st is None:
                # exclusive phase: first writer owns the field outright
                self._eraser[key] = [ident, {ident}, None, False]
                return
            owner, writers, candidates, reported = st
            if ident == owner and len(writers) == 1:
                return
            writers.add(ident)
            if candidates is None:
                # first genuinely shared write starts the lockset
                st[2] = candidates = set(held)
            else:
                candidates &= held
            if not candidates and not reported:
                st[3] = True
                self._violations.append(Violation(
                    kind="unguarded-write",
                    message=(f"{type(obj).__mro__[1].__name__}.{attr} "
                             f"written from {len(writers)} threads with an "
                             f"empty common lockset — no single lock "
                             f"consistently guards this field"),
                    thread=threading.current_thread().name,
                    details=(type(obj).__mro__[1].__name__, attr)))

    # ----------------------------------------------------------- results
    def violations(self) -> list[Violation]:
        with self._meta:
            return list(self._violations)

    def reset(self) -> None:
        """Clear findings and graphs; install/watch state is kept."""
        with self._meta:
            self._edges.clear()
            self._labels.clear()
            self._violations.clear()
            self._seen_cycles.clear()
            self._eraser.clear()

    def report(self) -> str:
        vs = self.violations()
        if not vs:
            return "lockguard: clean (0 violations)"
        lines = [f"lockguard: {len(vs)} violation(s)"]
        lines += [f"  {v}" for v in vs]
        return "\n".join(lines)

    def emit_metrics(self) -> None:
        """Publish counts on the observability metrics registry."""
        from ..observability import METRICS
        vs = self.violations()
        for kind in ("lock-order", "unguarded-write"):
            METRICS.gauge(
                "lockguard.violations." + kind.replace("-", "_"),
                sum(1 for v in vs if v.kind == kind))


LOCKGUARD = LockGuard()


@contextlib.contextmanager
def lockguard_active(guard: LockGuard | None = None):
    """Install around a block, uninstall after; yields the guard."""
    g = guard or LOCKGUARD
    g.install()
    try:
        yield g
    finally:
        g.uninstall()
