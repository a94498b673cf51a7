"""Static concurrency model for the LK01/LK02/LK03/TH01 rules.

The serving/training stack is threaded (serve loop, HTTP handler pool,
prefetch worker, scaleout heartbeats), and the classic failure modes —
an unlocked write racing the serve thread, two locks taken in opposite
orders, a device fence held under a lock — are exactly the bugs a test
suite only catches once in a thousand runs.  This module builds the
per-module facts those rules consume:

- **per-class field-access pass**: every write to ``self.<attr>`` in
  every method, annotated with the set of locks statically held at the
  write site (``with self._lock:`` scoping);
- **lock inventory**: attributes assigned from ``threading.Lock`` /
  ``RLock`` / ``Condition`` / ``Semaphore`` constructors, plus
  module-level / function-local lock names;
- **guarded-by annotations**: an explicit contract comment on any
  assignment line — ``self._slots = {}  # guarded-by: self._lock`` —
  declares that *every* non-``__init__`` write must hold that lock;
- **thread-entry reachability**: methods used as ``Thread(target=...)``,
  ``run`` on ``Thread`` subclasses, and ``do_GET``-style HTTP handler
  methods are entry roots; the per-class call graph (``self.m()`` edges)
  gives each method its set of executing *contexts* (which entry threads
  can reach it, and whether external callers can);
- **lock-order graph**: nested ``with`` acquisitions and one level of
  ``self.m()`` call propagation produce ``held -> acquired`` edges;
  cycles (including a non-reentrant lock re-acquired through a helper)
  are deadlock schedules.

Everything is best-effort and single-module, like the rest of graftlint:
reads are not tracked (only writes race destructively enough to flag),
``lock.acquire()`` / ``release()`` call pairs are not modelled (use
``with``), nested ``def`` bodies execute later so they are skipped, and
cross-module lock cycles are out of scope.  ``__init__``/``__new__``/
``__del__`` writes are exempt — construction happens-before publication.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Iterator

from .core import assigned_names, dotted_name, last_segment

#: threading constructors whose result we treat as a lock object, mapped
#: to whether acquisition is reentrant (a Condition wraps an RLock by
#: default, so we treat it as reentrant)
_LOCK_CTORS = {
    "threading.Lock": False,
    "threading.RLock": True,
    "threading.Condition": True,
    "threading.Semaphore": False,
    "threading.BoundedSemaphore": False,
}

#: container-mutating method names: ``self.x.append(...)`` is a write to x
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "clear", "add", "discard", "update",
    "setdefault", "sort", "reverse",
}

#: methods whose writes are construction, not sharing
_INIT_METHODS = {"__init__", "__new__", "__del__", "__post_init__"}

#: the external (caller-thread) context label
EXTERNAL = "external"

_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*self\.(\w+)")


def _self_attr(node: ast.AST) -> str | None:
    """``attr`` when ``node`` is exactly ``self.attr``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


@dataclasses.dataclass
class FieldWrite:
    """One store/mutation of ``self.<attr>`` at one source location."""

    attr: str
    method: str
    node: ast.AST
    held: frozenset[str]      # lock attrs of the class held at the write


@dataclasses.dataclass
class LockAcquire:
    """One static ``with <lock>`` acquisition site."""

    lock_id: str              # "Class.attr" or "global:name"
    node: ast.AST
    func: str                 # qualified function/method name


@dataclasses.dataclass
class OrderEdge:
    """``held`` was locked when ``acquired`` was taken at ``node``."""

    held: str
    acquired: str
    node: ast.AST
    func: str


class ClassConcurrency:
    """The field/lock/thread facts for one class definition."""

    def __init__(self, module, node: ast.ClassDef):
        self.module = module
        self.node = node
        self.name = node.name
        self.methods: dict[str, ast.FunctionDef] = {
            s.name: s for s in node.body
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.lock_attrs: dict[str, bool] = {}      # attr -> reentrant?
        self.guarded_by: dict[str, str] = {}       # attr -> lock attr
        self.writes: dict[str, list[FieldWrite]] = {}
        self.calls: dict[str, set[str]] = {m: set() for m in self.methods}
        #: (caller, callee, locks statically held at the call site)
        self.call_sites: list[tuple[str, str, frozenset[str]]] = []
        self.acquired_in: dict[str, set[str]] = {m: set() for m in self.methods}
        self.entry_methods: set[str] = set()
        self.spawns_threads = False
        self._collect()

    # ---------------------------------------------------------------- facts
    def _collect(self) -> None:
        subclasses_thread = any(
            (dotted_name(b) or "").endswith("Thread") for b in self.node.bases)
        for name, fn in self.methods.items():
            if name.startswith("do_") and name[3:].isupper():
                self.entry_methods.add(name)        # BaseHTTPRequestHandler
            if name == "run" and subclasses_thread:
                self.entry_methods.add(name)
            self._scan_method(fn)
        # transitive lock acquisition closure over self.m() calls
        changed = True
        while changed:
            changed = False
            for m, callees in self.calls.items():
                for c in callees:
                    extra = self.acquired_in.get(c, set()) - self.acquired_in[m]
                    if extra:
                        self.acquired_in[m] |= extra
                        changed = True
        self._apply_held_floors()

    def _apply_held_floors(self) -> None:
        """Interprocedural lock context: a private helper whose every
        in-class call site holds lock L runs with L held (the
        ``_helper_locked`` convention) — fold that floor into its
        writes.  Entry methods and public methods get no floor: the
        thread runtime / external callers invoke them bare."""
        floors: dict[str, frozenset[str]] = {}
        for _ in range(len(self.methods)):
            changed = False
            for m in self.methods:
                if m in self.entry_methods or not m.startswith("_") \
                        or m in _INIT_METHODS:
                    continue
                sites = [held | floors.get(caller, frozenset())
                         for caller, callee, held in self.call_sites
                         if callee == m]
                if not sites:
                    continue
                floor = frozenset.intersection(*sites)
                if floor and floors.get(m) != floor:
                    floors[m] = floor
                    changed = True
            if not changed:
                break
        for ws in self.writes.values():
            for i, w in enumerate(ws):
                floor = floors.get(w.method)
                if floor:
                    ws[i] = dataclasses.replace(w, held=w.held | floor)

    def _scan_method(self, fn: ast.FunctionDef) -> None:
        self._walk(fn.body, fn.name, frozenset())

    def _walk(self, stmts, method: str, held: frozenset[str]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                     # executes later / elsewhere
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                newly = set()
                for item in stmt.items:
                    attr = _self_attr(item.context_expr)
                    if attr is None:
                        continue
                    line = self.module.line(item.context_expr.lineno)
                    # a with on a known lock attr, or one that *looks*
                    # like a lock contract even before we saw the ctor
                    if attr in self.lock_attrs or self._lockish(attr):
                        newly.add(attr)
                self._scan_stmt_exprs(stmt, method, held, header_only=True)
                self._walk(stmt.body, method, held | frozenset(newly))
                continue
            self._scan_stmt_exprs(stmt, method, held)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    self._walk(sub, method, held)
            for handler in getattr(stmt, "handlers", []) or []:
                self._walk(handler.body, method, held)

    def _lockish(self, attr: str) -> bool:
        """Is ``self.<attr>`` plausibly a lock even if its constructor was
        not seen yet (methods are scanned before __init__ sometimes)?"""
        init = self.methods.get("__init__")
        if init is None:
            return False
        for node in ast.walk(init):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                canon = self.module.canonical(node.value.func) or ""
                if canon in _LOCK_CTORS:
                    for t in node.targets:
                        if _self_attr(t) == attr:
                            return True
        return False

    def _scan_stmt_exprs(self, stmt: ast.stmt, method: str,
                         held: frozenset[str], header_only: bool = False) -> None:
        """Record writes, lock ctors, guarded-by annotations, and self-call
        edges found in one statement (its own expressions only — compound
        bodies are walked separately so ``held`` stays accurate)."""
        for node in self._own_nodes(stmt, header_only):
            # lock constructor: self._lock = threading.Lock()
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                canon = self.module.canonical(node.value.func) or ""
                if canon in _LOCK_CTORS:
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            self.lock_attrs[attr] = _LOCK_CTORS[canon]
            # guarded-by annotation on any line assigning self.attr
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                m = _GUARDED_BY_RE.search(self.module.line(node.lineno))
                if m:
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        attr = _self_attr(t) or _self_attr(
                            t.value if isinstance(t, ast.Subscript) else t)
                        if attr is not None:
                            self.guarded_by[attr] = m.group(1)
            # attribute writes
            if isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, (ast.Store, ast.Del)):
                attr = _self_attr(node)
                if attr is not None:
                    self._record_write(attr, method, node, held)
            elif isinstance(node, ast.Subscript) and isinstance(
                    node.ctx, (ast.Store, ast.Del)):
                attr = _self_attr(node.value)
                if attr is not None:
                    self._record_write(attr, method, node, held)
            elif isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _MUTATORS):
                    attr = _self_attr(node.func.value)
                    if attr is not None:
                        self._record_write(attr, method, node, held)
                # self.m() call edge
                callee = _self_attr(node.func)
                if callee is not None and callee in self.methods:
                    self.calls[method].add(callee)
                    self.call_sites.append((method, callee, held))
                # thread spawn + target entry method
                canon = self.module.canonical(node.func) or ""
                if canon == "threading.Thread" or canon.endswith(".Thread"):
                    self.spawns_threads = True
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target = _self_attr(kw.value)
                            if target is not None and target in self.methods:
                                self.entry_methods.add(target)
            # with self._lock: acquisition inventory (for LK02 closure)
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and (attr in self.lock_attrs
                                             or self._lockish(attr)):
                        self.acquired_in[method].add(attr)

    def _own_nodes(self, stmt: ast.stmt, header_only: bool) -> Iterator[ast.AST]:
        """``stmt`` and its expression children, not descending into the
        bodies of compound statements or nested defs."""
        yield stmt
        blocked = {"body", "orelse", "finalbody", "handlers"}
        stack = [c for f, c in ast.iter_fields(stmt)
                 if f not in blocked for c in (c if isinstance(c, list) else [c])
                 if isinstance(c, ast.AST)]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            yield n
            stack.extend(c for c in ast.iter_child_nodes(n))

    def _record_write(self, attr: str, method: str, node: ast.AST,
                      held: frozenset[str]) -> None:
        if attr in self.lock_attrs:
            return
        self.writes.setdefault(attr, []).append(
            FieldWrite(attr=attr, method=method, node=node, held=held))

    # ---------------------------------------------------------------- queries
    @property
    def threaded(self) -> bool:
        """Does this class run code on more than the caller's thread?"""
        return self.spawns_threads or bool(self.entry_methods)

    def entry_reachable(self) -> dict[str, set[str]]:
        """method -> set of entry roots whose thread can execute it."""
        reach: dict[str, set[str]] = {}
        for root in self.entry_methods:
            seen = {root}
            stack = [root]
            while stack:
                for callee in self.calls.get(stack.pop(), ()):
                    if callee not in seen:
                        seen.add(callee)
                        stack.append(callee)
            for m in seen:
                reach.setdefault(m, set()).add(root)
        return reach

    def contexts(self, method: str) -> frozenset[str]:
        """The set of thread contexts that can execute ``method``: one
        label per reaching entry root, plus ``external`` when a method
        outside every entry closure can call it (or it IS one)."""
        reach = self.entry_reachable()
        ctx = set(reach.get(method, ()))
        if method not in reach:
            ctx.add(EXTERNAL)
        else:
            for caller, callees in self.calls.items():
                if method in callees and caller not in reach:
                    ctx.add(EXTERNAL)
                    break
        return frozenset(ctx)


class ModuleConcurrency:
    """All classes of a module, plus the module-wide lock-order graph."""

    def __init__(self, module):
        self.module = module
        self.classes = [ClassConcurrency(module, n)
                        for n in ast.walk(module.tree)
                        if isinstance(n, ast.ClassDef)]
        self._global_locks = self._collect_global_locks()
        self.edges: list[OrderEdge] = []
        self.blocking: list[tuple[ast.Call, str, str]] = []  # node, why, func
        self._lock_kinds: dict[str, bool] = {}     # lock id -> reentrant?
        self._build_order_and_blocking()

    # ------------------------------------------------------------- inventory
    def _collect_global_locks(self) -> dict[str, bool]:
        locks: dict[str, bool] = {}
        for node in ast.walk(self.module.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                canon = self.module.canonical(node.value.func) or ""
                if canon in _LOCK_CTORS:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            locks[t.id] = _LOCK_CTORS[canon]
        return locks

    def _cls_for(self, fn: ast.FunctionDef) -> ClassConcurrency | None:
        for cls in self.classes:
            if fn.name in cls.methods and cls.methods[fn.name] is fn:
                return cls
        return None

    def _lock_id(self, expr: ast.AST, cls: ClassConcurrency | None) -> str | None:
        attr = _self_attr(expr)
        if attr is not None and cls is not None and (
                attr in cls.lock_attrs or cls._lockish(attr)):
            return f"{cls.name}.{attr}"
        if isinstance(expr, ast.Name) and expr.id in self._global_locks:
            return f"global:{expr.id}"
        return None

    def _reentrant(self, lock_id: str, cls: ClassConcurrency | None) -> bool:
        if lock_id.startswith("global:"):
            return self._global_locks.get(lock_id[7:], False)
        if cls is not None and "." in lock_id:
            return cls.lock_attrs.get(lock_id.split(".", 1)[1], True)
        return True

    # ------------------------------------------------------- order + blocking
    def _build_order_and_blocking(self) -> None:
        for node in ast.walk(self.module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls = self._cls_for(node)
                qual = f"{cls.name}.{node.name}" if cls else node.name
                self._walk_fn(node.body, cls, qual, [])

    def _walk_fn(self, stmts, cls, qual: str,
                 held: list[tuple[str, str]]) -> None:
        """held: list of (lock_id, receiver source text) in acquisition
        order for the current static scope."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                entered = list(held)
                for item in stmt.items:
                    lock_id = self._lock_id(item.context_expr, cls)
                    if lock_id is None:
                        continue
                    for h, _ in entered:
                        if h == lock_id and self._reentrant(lock_id, cls):
                            continue
                        self.edges.append(OrderEdge(
                            held=h, acquired=lock_id,
                            node=item.context_expr, func=qual))
                    entered.append(
                        (lock_id, dotted_name(item.context_expr) or lock_id))
                if len(entered) > len(held):
                    self._scan_calls(stmt, cls, qual, held, header_only=True)
                    self._walk_fn(stmt.body, cls, qual, entered)
                    continue
            if held:
                self._scan_calls(stmt, cls, qual, held)
            else:
                # still record self.m() edges for transitive acquisition
                pass
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    self._walk_fn(sub, cls, qual, held)
            for handler in getattr(stmt, "handlers", []) or []:
                self._walk_fn(handler.body, cls, qual, held)

    def _scan_calls(self, stmt: ast.stmt, cls, qual: str,
                    held: list[tuple[str, str]],
                    header_only: bool = False) -> None:
        """Under ``held`` locks: record blocking calls (LK03) and edges
        from held locks to every lock a called sibling method acquires."""
        if not held:
            return
        blocked = {"body", "orelse", "finalbody", "handlers"}
        stack = [c for f, c in ast.iter_fields(stmt)
                 if f not in blocked for c in (c if isinstance(c, list) else [c])
                 if isinstance(c, ast.AST)]
        if isinstance(stmt, ast.expr):
            stack = [stmt]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(n, ast.Call):
                why = self._blocking_reason(n, held)
                if why:
                    self.blocking.append((n, why, qual))
                callee = _self_attr(n.func)
                if (callee is not None and cls is not None
                        and callee in cls.methods):
                    for inner in cls.acquired_in.get(callee, ()):
                        inner_id = f"{cls.name}.{inner}"
                        for h, _ in held:
                            if h == inner_id and not self._reentrant(
                                    inner_id, cls):
                                # non-reentrant lock re-acquired via helper:
                                # a guaranteed self-deadlock schedule
                                self.edges.append(OrderEdge(
                                    held=h, acquired=inner_id,
                                    node=n, func=qual))
                            elif h != inner_id:
                                self.edges.append(OrderEdge(
                                    held=h, acquired=inner_id,
                                    node=n, func=qual))
            stack.extend(ast.iter_child_nodes(n))

    def _blocking_reason(self, call: ast.Call,
                         held: list[tuple[str, str]]) -> str | None:
        """Why ``call`` can block indefinitely (None when it cannot)."""
        canon = self.module.canonical(call.func) or ""
        base = last_segment(canon) if canon else ""
        has_args = bool(call.args or call.keywords)
        kwnames = {kw.arg for kw in call.keywords}
        if canon == "torch.cuda.synchronize":
            return "device fence (torch.cuda.synchronize)"
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            recv = dotted_name(call.func.value)
            if attr == "synchronize" and not has_args:
                return "device fence (.synchronize())"
            if attr == "wait" and not has_args:
                if any(recv == text for _, text in held):
                    return None        # Condition.wait releases its own lock
                return "untimed .wait()"
            if attr == "join" and not has_args:
                return "untimed .join()"
            if attr in ("get", "result") and not call.args \
                    and "timeout" not in kwnames:
                if attr == "get" and has_args:
                    return None        # dict.get(key[, default]) style
                if not has_args:
                    return f"untimed .{attr}()"
            if attr in ("recv", "accept", "makefile", "getresponse"):
                return f"socket I/O (.{attr})"
        if canon == "time.sleep":
            return "time.sleep under lock (convoy)"
        if canon.startswith("urllib.request.") or base == "urlopen":
            return "HTTP I/O (urlopen)"
        return None


def module_concurrency(module) -> ModuleConcurrency:
    """Build (and memoize on the ModuleInfo) the concurrency model."""
    cached = getattr(module, "_concurrency", None)
    if cached is None:
        cached = ModuleConcurrency(module)
        module._concurrency = cached
    return cached


def find_cycles(edges: list[OrderEdge]) -> list[list[OrderEdge]]:
    """Every elementary cycle in the lock-order graph, as edge lists.
    Self-edges (non-reentrant re-acquisition) are length-1 cycles."""
    by_src: dict[str, list[OrderEdge]] = {}
    for e in edges:
        by_src.setdefault(e.held, []).append(e)
    cycles: list[list[OrderEdge]] = []
    seen_keys: set[frozenset[tuple[str, str]]] = set()

    for start in sorted(by_src):
        def dfs(node: str, path: list[OrderEdge], visited: set[str]) -> None:
            for e in by_src.get(node, ()):
                if e.acquired == start:
                    cyc = path + [e]
                    key = frozenset((c.held, c.acquired) for c in cyc)
                    if key not in seen_keys:
                        seen_keys.add(key)
                        cycles.append(cyc)
                elif e.acquired not in visited and e.acquired > start:
                    dfs(e.acquired, path + [e], visited | {e.acquired})

        dfs(start, [], {start})
    return cycles
