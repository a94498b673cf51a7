"""The graftlint rule set for the PyTorch/CUDA port — twenty-three hazard
classes from this repo's history.

Port of ``deeplearning4j_tpu/analysis/rules.py``.  Each rule keeps its id
where the hazard carries over to torch code:

| rule  | hazard                                                           |
|-------|------------------------------------------------------------------|
| HS01  | host sync (`.item()`/`.cpu()`/`.tolist()`/`.numpy()`/`float`/    |
|       | `int`/`bool`/`np.asarray`) of a device-produced value in a hot   |
|       | path, outside `allow_transfers()`                                |
| RNG01 | one seed feeding two generators (`manual_seed`, `key_for`,       |
|       | `RngStream`) with no reassignment between them, or a loop that   |
|       | reseeds from a seed it never rebinds — identical "random" draws  |
| TB01  | Python `if`/`while`/`and`/`or` on a device tensor in a hot path  |
|       | (a hidden `.item()`)                                             |
| HOT02 | loop dispatching device work with no `trace.span`/`METRICS`      |
|       | instrumentation anywhere in reach                                |
| EXC01 | bare `except:` — catches SystemExit/KeyboardInterrupt, so a      |
|       | retry/supervision loop becomes unkillable and every failure      |
|       | signal is swallowed untyped                                      |
| PL01  | a CUDA kernel registered in `ops/cuda/registry.py` or loaded     |
|       | through `ops/cuda/build.py` with no plain torch version          |
|       | registered beside it — the CPU tests can never hold it to one    |
| ZR01  | a gather of ZeRO optimizer state to the full layout              |
|       | (`global_block`/`all_gather`) outside `checkpoint`/              |
|       | `final_params` with no `zero_stage` gate — undoes the 1/ndp win  |
| LK01  | unguarded write to a lock-guarded / thread-shared attribute      |
|       | (explicit `# guarded-by:` contract, majority-guarded inference,  |
|       | or written from two thread contexts with no lock ever held)      |
| LK02  | inconsistent lock-acquisition order: the static lock-order       |
|       | graph (nested `with` + helper-call propagation) has a cycle —    |
|       | a deadlock schedule, incl. non-reentrant self-re-acquisition     |
| LK03  | blocking call while holding a lock (`torch.cuda.synchronize`,    |
|       | `.synchronize()`, untimed `.wait()`/`.join()`/`.get()`,          |
|       | socket/HTTP I/O, `time.sleep`) — a convoy or deadlock            |
| TH01  | `threading.Thread` created with neither `daemon=True` nor a      |
|       | visible `join()`/daemon-flag lifecycle — leaks a thread that     |
|       | can hang interpreter shutdown                                    |
| PG01  | KV page acquire (`alloc`/`incref`/`lookup_prefix` on a page      |
|       | pool, `serving/` modules) with no `decref`-style release on the  |
|       | exceptional exit paths — leaked pinned pages 429 the pool        |
| OB01  | direct `time.monotonic()`/`perf_counter()` timing of dispatch    |
|       | in `serving/`/`parallel/` with no registry/tracer call in reach  |
| QT01  | raw `.to(torch.int8)` / cast to an fp8 dtype in `serving/` or    |
|       | `models/` outside the quant helpers (`ops/cuda/kv_quant.py`,     |
|       | `matmul_int8.py`) — an unscaled, unsaturated cast                |
| EL01  | `Mesh(`, `dist.new_group(` or `init_process_group(` in           |
|       | `parallel/`/`resilience/` outside `parallel/mesh.py` — a group   |
|       | the elastic resize path cannot rebuild                           |
| OB02  | literal metric name passed to `METRICS.increment/gauge/          |
|       | observe_time/time` that is missing from the documented metrics   |
|       | tables (README.md / DESIGN.md)                                   |
| OB03  | request-derived data (tenant/request/session/user ids, prompt    |
|       | text) interpolated into a metric name outside the bounded        |
|       | tenant-label helper                                              |
| OL01  | non-durable file rewrite on the online-loop / checkpoint publish |
|       | path outside the unique-tempfile + fsync + `os.replace` idiom    |
| SH01  | collective of `parallel/collectives.py` over an axis no          |
|       | enclosing `with mesh:` binds — the collective is the identity    |
| SH02  | `P(...)` naming an axis absent from `parallel/mesh.py` `AXES`    |
| NM01  | `torch.exp` normalized by its own sum, or `log(sum(exp))`, in    |
|       | `ops/`/`models/` without subtracting the max                     |
| CT01  | raw ring/pool mutation in `control/` — the control plane must    |
|       | scale through the `ReplicaPool`/`PrefixRouter` seams             |
| DG01  | page accounting or block-table write in `serving/disagg/`        |
|       | outside the `KVMigrator` export/import seams                     |

Four reference rules have no torch counterpart and are not registered:
RC01 (recompile storms: the port compiles nothing per shape, the CUDA
kernels build once at first use in ``ops/cuda/build.py::build_all``),
DON01 (use after ``donate_argnums``: nothing is donated; the steps that
update their inputs in place — the engine's decode state — do it because
that state IS what the caller reads next), SH03 (``shard_map`` spec
arity: there is no ``shard_map``; ranks run the step SPMD) and SH04
(donation through a reshard: no donation and no jit ``in_shardings``).
``ROADMAP.md`` A11 records the same.

Each rule documents its known blind spots; deliberate hits are silenced
inline with ``# graftlint: disable=<RULE>`` plus a reason, or carried in
the committed baseline (``graftlint_torch.baseline.json``) with a
justification.
"""

from __future__ import annotations

import ast
import pathlib
import re
from collections import Counter
from typing import Iterator

from .concurrency import _INIT_METHODS, find_cycles, module_concurrency
from .core import (
    Finding,
    Rule,
    assigned_names,
    body_statements,
    dotted_name,
    last_segment,
    names_read,
    register,
    statement_targets,
)
from .jitinfo import ModuleInfo
from .sharding import axis_registry, sharding_info

#: callables whose canonical name forces a device->host read of their arg
_SYNC_CALLS = {
    "float", "int", "bool",
    "numpy.asarray", "numpy.array",
}
#: method names that force a device->host read of their receiver
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

#: attributes of a device tensor that the host holds (no sync to read)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "size", "dim", "numel", "element_size"}

#: observability markers — any of these in reach means the loop reports
#: through the observability layer
_OBS_MARKERS = ("span", "observe_time", "observe_many", "increment",
                "gauge", "time", "iteration_done", "record_span")


def _function_loops(fn: ast.FunctionDef) -> list[ast.stmt]:
    """Top-to-bottom list of loop statements in ``fn`` (not nested defs)."""
    loops = []
    for stmt in body_statements(fn.body):
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            loops.append(stmt)
    return loops


def _calls_in(node: ast.AST) -> Iterator[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def _is_sync_call(module: ModuleInfo, call: ast.Call) -> ast.AST | None:
    """The expression being synced to host, or None."""
    canon = module.canonical(call.func)
    if canon in _SYNC_CALLS and call.args:
        return call.args[0]
    if (isinstance(call.func, ast.Attribute)
            and call.func.attr in _SYNC_METHODS and not call.args):
        return call.func.value
    return None


def _allowed_ids(module: ModuleInfo, fn: ast.AST) -> set[int]:
    """ids of nodes inside an ``allow_transfers()`` fence — a ``with``
    block, or a function it decorates: where a sync is the point."""
    def fence(expr) -> bool:
        return isinstance(expr, ast.Call) and last_segment(
            module.canonical(expr.func) or "") == "allow_transfers"

    out: set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                fence(it.context_expr) for it in node.items):
            body = node.body
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and any(fence(d) for d in node.decorator_list):
            body = node.body
        else:
            continue
        for stmt in body:
            out.update(id(n) for n in ast.walk(stmt))
    return out


def _device_taint(module: ModuleInfo, fn: ast.FunctionDef) -> set[str]:
    """Names bound in ``fn`` from a device-producing call."""
    tainted: set[str] = set()
    for stmt in body_statements(fn.body):
        if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, (ast.Call, ast.Tuple)):
            if any(module.is_device_call(c) for c in _calls_in(stmt.value)):
                for t in stmt.targets:
                    tainted.update(assigned_names(t))
    return tainted


def _hits(tainted: set[str], reads: set[str]) -> set[str]:
    """Tainted names among ``reads`` (``t.sum`` reads ``t``)."""
    return {n for n in tainted for r in reads
            if r == n or r.startswith(n + ".")}


def _loop_node_ids(fn: ast.FunctionDef) -> set[int]:
    out: set[int] = set()
    for loop in _function_loops(fn):
        out.update(id(n) for n in ast.walk(loop))
    return out


@register
class HostSyncRule(Rule):
    """HS01 — device->host sync of a device-produced value in a hot path.

    Taint: names bound from a device-producing call inside the same
    function (a step callable, a kernel wrapper, an ``nn.Module``, a
    ``torch.*`` factory given ``device=``; see ``jitinfo``).  A sync
    (``float``/``int``/``bool``/``np.asarray`` of it, or its ``.item()``/
    ``.cpu()``/``.tolist()``/``.numpy()``) fires when it happens (a)
    inside a loop, or (b) anywhere in a loop-free function — the per-call
    method whose *caller* is the loop — unless it sits inside a ``with
    allow_transfers():`` fence.  Syncs after a loop in a loop-containing
    function are treated as deliberate fences and left alone.
    """

    id = "HS01"
    title = "host sync on device-produced value in hot path"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(module, node)

    def _check_function(self, module: ModuleInfo,
                        fn: ast.FunctionDef) -> Iterator[Finding]:
        tainted = _device_taint(module, fn)
        has_loop = bool(_function_loops(fn))
        loop_nodes = _loop_node_ids(fn)
        allowed = _allowed_ids(module, fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or id(node) in allowed:
                continue
            arg = _is_sync_call(module, node)
            if arg is None:
                continue
            hit = _hits(tainted, names_read(arg))
            # direct form: float(self._step_fn(...))
            if not hit:
                inner = [c for c in _calls_in(arg) if module.is_device_call(c)]
                if inner:
                    hit = {dotted_name(inner[0].func) or "<call>"}
            if not hit:
                continue
            in_loop = id(node) in loop_nodes
            if in_loop or not has_loop:
                where = ("inside a loop" if in_loop
                         else "in a loop-free per-call function")
                yield self.finding(
                    module, node,
                    f"host sync of device-produced value {sorted(hit)[0]!r} "
                    f"{where}: the host waits for the CUDA stream to drain "
                    "every call — return the device value and resolve at "
                    "the caller's fence (LazyLoss pattern, DESIGN.md §10), "
                    "under allow_transfers()")


def _bare_reads(node: ast.AST, names: set[str]) -> set[str]:
    """Names read under ``node`` EXCLUDING reads through host-held
    attributes (``x.shape[0]``, ``x.device`` do not read ``x``'s
    values), ``len``/``isinstance``-style calls and explicit reads
    (``int(x)``, ``x.item()``: HS01's)."""
    out: set[str] = set()

    def visit(n: ast.AST) -> None:
        if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
            return
        if isinstance(n, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
            return       # identity tests read no value
        if isinstance(n, ast.Call):
            canon_last = last_segment(dotted_name(n.func) or "")
            if canon_last in ("len", "isinstance", "type", "getattr",
                              "hasattr", "is_tensor", "callable"):
                return
            if canon_last in _SYNC_CALLS or (
                    isinstance(n.func, ast.Attribute)
                    and n.func.attr in _SYNC_METHODS):
                return     # an explicit read: HS01's finding, not TB01's
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                and n.id in names:
            out.add(n.id)
        for child in ast.iter_child_nodes(n):
            visit(child)

    visit(node)
    return out


def _rebound(name: str, assigned) -> bool:
    """Whether ``name`` or a prefix of it (``req`` for ``req.seed``) is
    in ``assigned``."""
    parts = name.split(".")
    return any(".".join(parts[:i]) in assigned
               for i in range(1, len(parts) + 1))


def _forget(used: dict, rebound) -> None:
    for key in [k for k in used if _rebound(k, rebound)]:
        used.pop(key)


@register
class KeyReuseRule(Rule):
    """RNG01 — one seed feeding two generators.

    The reference's hazard is a JAX key consumed twice; a torch
    ``Generator`` advances with every draw, so drawing twice from one is
    sound — the counterpart is the SEED: two generators seeded from the
    same value (``g.manual_seed(s)``, ``torch.manual_seed(s)``,
    ``ops.rng.key_for(s)``, ``RngStream(s)``) produce the same stream.
    Linear scan per function: every seeding call consumes its seed name; a
    second consumption of the same (dotted) name with no reassignment of
    it (or of a prefix: ``req`` rebinds ``req.seed``) in between fires.
    A seeding inside a loop whose seed is never reassigned in that loop
    body fires too (identical "randomness" every step).  Draws from a
    stream (``next_key``, ``split``) are not seedings.
    """

    id = "RNG01"
    title = "one seed feeding two generators"

    #: callables whose first argument seeds a fresh stream, by basename
    _SEEDERS = {"manual_seed", "manual_seed_all", "key_for", "RngStream",
                "_generator"}

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(module, node)

    def _key_arg(self, module: ModuleInfo, call: ast.Call) -> str | None:
        name = (call.func.attr if isinstance(call.func, ast.Attribute)
                else last_segment(module.canonical(call.func) or ""))
        if name not in self._SEEDERS or not call.args:
            return None
        return dotted_name(call.args[0])

    def _check_function(self, module: ModuleInfo,
                        fn: ast.FunctionDef) -> Iterator[Finding]:
        yield from self._scan(module, fn.body, {}, frozenset())

    @staticmethod
    def _terminates(body: list[ast.stmt]) -> bool:
        """Whether control never falls past the end of ``body``."""
        return bool(body) and isinstance(
            body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))

    def _draws(self, module: ModuleInfo, node: ast.AST,
               used_once: dict[str, int],
               skip: frozenset) -> Iterator[Finding]:
        """Register/flag key consumptions in one expression or simple
        statement (no statement-level branching below this node)."""
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            key = self._key_arg(module, n)
            if key is None or key in skip:
                continue
            if key in used_once:
                yield self.finding(
                    module, n,
                    f"seed {key!r} already seeded a generator at line "
                    f"{used_once[key]} with no reassignment since — two "
                    "generators from one seed draw the same stream; "
                    "derive a fresh seed (RngStream.next_key)")
            else:
                used_once[key] = n.lineno

    def _scan(self, module: ModuleInfo, body: list[ast.stmt],
              used_once: dict[str, int],
              skip: frozenset) -> Iterator[Finding]:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                loop_assigned: set[str] = set()
                for s in body_statements(stmt.body):
                    loop_assigned.update(statement_targets(s))
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    loop_assigned.update(assigned_names(stmt.target))
                flagged: set[str] = set()
                for s in stmt.body:
                    for n in ast.walk(s):
                        if isinstance(n, ast.Call):
                            key = self._key_arg(module, n)
                            if (key is not None
                                    and not _rebound(key, loop_assigned)
                                    and key not in skip
                                    and key not in flagged):
                                flagged.add(key)
                                yield self.finding(
                                    module, n,
                                    f"seed {key!r} reseeds a generator "
                                    "every loop iteration but is never "
                                    "reassigned in the loop — identical "
                                    "random draws each step")
                # intra-iteration reuse of keys that ARE rebound per step
                yield from self._scan(module, stmt.body, {},
                                      skip | flagged)
                used_once.clear()
                continue
            if isinstance(stmt, ast.If):
                yield from self._draws(module, stmt.test, used_once, skip)
                # branches are mutually exclusive: scan each from a copy of
                # the current state, then merge the states that fall through
                states: list[dict[str, int]] = []
                for branch in (stmt.body, stmt.orelse):
                    st = dict(used_once)
                    if branch:
                        yield from self._scan(module, branch, st, skip)
                    if not branch or not self._terminates(branch):
                        states.append(st)
                used_once.clear()
                for st in states:
                    used_once.update(st)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    yield from self._draws(module, item.context_expr,
                                           used_once, skip)
                _forget(used_once, statement_targets(stmt))
                yield from self._scan(module, stmt.body, used_once, skip)
                continue
            if isinstance(stmt, ast.Try):
                merged = dict(used_once)
                yield from self._scan(module, stmt.body, merged, skip)
                for handler in stmt.handlers:
                    hs = dict(used_once)
                    yield from self._scan(module, handler.body, hs, skip)
                    merged.update(hs)
                if stmt.orelse:
                    yield from self._scan(module, stmt.orelse, merged, skip)
                if stmt.finalbody:
                    yield from self._scan(module, stmt.finalbody, merged,
                                          skip)
                used_once.clear()
                used_once.update(merged)
                continue
            # simple statement: uses first, then (re)binds
            yield from self._draws(module, stmt, used_once, skip)
            _forget(used_once, statement_targets(stmt))



@register
class TracedBranchRule(Rule):
    """TB01 — Python control flow on a device tensor in a hot path.

    ``if t:``, ``while t:``, ``t and u``, ``not t`` and ``a if t else b``
    on a CUDA tensor call ``bool(t)`` — a hidden ``.item()`` that waits
    for the stream (the reference's traced-value branch, which
    concretizes a tracer).  Fires on such tests that read a name bound
    from a device-producing call (HS01's taint) bare, inside a loop or in
    a loop-free per-call function, outside ``allow_transfers()``.
    ``is``/``is not`` tests and reads through host-held attributes
    (``t.shape``, ``t.device``, ``t.dtype``) and ``len``/``isinstance``
    calls are allowed — the host holds those.
    """

    id = "TB01"
    title = "python branch on a device tensor in hot path"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(module, node)

    @staticmethod
    def _tests(fn: ast.AST):
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                yield node, node.test
            elif isinstance(node, ast.BoolOp):
                for v in node.values:
                    yield node, v
            elif isinstance(node, ast.UnaryOp) \
                    and isinstance(node.op, ast.Not):
                yield node, node.operand

    def _check_function(self, module: ModuleInfo,
                        fn: ast.FunctionDef) -> Iterator[Finding]:
        tainted = _device_taint(module, fn)
        if not tainted:
            return
        has_loop = bool(_function_loops(fn))
        loop_nodes = _loop_node_ids(fn)
        allowed = _allowed_ids(module, fn)
        seen: set[int] = set()      # one finding a line
        for node, test in self._tests(fn):
            if node.lineno in seen or id(node) in allowed:
                continue
            if not (id(node) in loop_nodes or not has_loop):
                continue
            if isinstance(test, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
                continue
            bare = _bare_reads(test, tainted)
            if bare:
                seen.add(node.lineno)
                kind = {ast.While: "while", ast.If: "if",
                        ast.IfExp: "if-expression", ast.BoolOp: "and/or",
                        ast.UnaryOp: "not"}[type(node)]
                yield self.finding(
                    module, node,
                    f"python `{kind}` on device tensor "
                    f"{sorted(bare)[0]!r} in a hot path — bool() of a CUDA "
                    "tensor waits for the stream (a hidden .item()); keep "
                    "the choice on the device (torch.where) or read it at "
                    "a fence")


@register
class UninstrumentedHotLoopRule(Rule):
    """HOT02 — device-dispatching loops invisible to observability.

    A loop that calls a jitted callable (directly, or through a local
    helper that does) with no ``trace.span``/``METRICS``/timer call
    anywhere in the loop body or its enclosing function bypasses the
    observability layer: its steps appear in no histogram, no trace, no
    ``/metrics.prom`` scrape.  One span or counter anywhere in reach —
    even per-epoch around the loop — satisfies the rule.
    """

    id = "HOT02"
    title = "uninstrumented device-dispatching loop"

    @staticmethod
    def _has_obs(node: ast.AST, module: ModuleInfo) -> bool:
        for call in _calls_in(node):
            name = dotted_name(call.func) or ""
            base, _, attr = name.rpartition(".")
            if attr in _OBS_MARKERS and (
                    last_segment(base) in ("trace", "METRICS", "TRACER",
                                           "registry")
                    or base.endswith("METRICS") or "observ" in base):
                return True
            canon = module.canonical(call.func) or ""
            if "observability" in canon or canon.endswith(".span"):
                return True
        return False

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            fn_has_obs = self._has_obs(node, module)
            if fn_has_obs:
                continue
            for loop in _function_loops(node):
                dispatches = None
                for call in _calls_in(loop):
                    callee = dotted_name(call.func)
                    if callee and module.is_dispatching_call(callee, call):
                        dispatches = callee
                        break
                if dispatches is None:
                    continue
                yield self.finding(
                    module, loop,
                    f"loop dispatches device work ({dispatches!r}) with no "
                    "trace.span/METRICS instrumentation in reach — add a "
                    "span or counter (per-epoch is enough) so the "
                    "observability layer sees this hot path")
                break  # one finding per function is enough signal



@register
class BareExceptRule(Rule):
    """EXC01 — bare ``except:`` clauses.

    A bare handler catches ``SystemExit``, ``KeyboardInterrupt``, and
    ``GeneratorExit`` along with everything else.  In this codebase's
    retry/supervision paths (resilience supervisor, scaleout worker
    loops) that is exactly wrong twice over: the process becomes
    unkillable under retry, and the retry policy's ``retry_on`` typing is
    bypassed — every failure looks retryable.  Catch ``Exception`` (or
    narrower) instead; if the broad catch is deliberate, re-raise the
    exit exceptions first.
    """

    id = "EXC01"
    title = "bare except swallows exit signals"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield self.finding(
                    module, node,
                    "bare `except:` catches SystemExit/KeyboardInterrupt — "
                    "a retry loop built on this cannot be killed and treats "
                    "every failure as retryable; catch Exception (or the "
                    "policy's retry_on tuple) instead")



#: registry calls that make a kernel selectable, and the kernel loaders
_PL_LOADERS = {"build.load", "build.function"}


@register
class PlainVersionRule(Rule):
    """PL01 — a CUDA kernel with no plain torch version beside it.

    The reference's rule is that every Pallas kernel runs its real body
    in the CPU tests (``interpret=``); the port's is that every kernel
    has a plain PyTorch version registered beside it — the wrappers take
    it on a CPU tensor, the CPU tests hold the port to the JAX package
    through it, and ``chip_smoke.py`` holds each kernel to it on the
    card.  Fires on a ``registry.register(KernelCandidate(...))`` of a
    CUDA candidate (``source`` absent or ``"cuda"``) with no
    ``reference=`` (or ``reference=None``), and on a kernel load through
    ``ops/cuda/build.py`` (``build.load``/``build.function``) in a module
    that registers no CUDA candidate with a reference.

    Blind spots: a candidate built in one module and registered in
    another; a loader aliased through a variable.
    """

    id = "PL01"
    title = "CUDA kernel without a registered plain version"

    @staticmethod
    def _candidate(module: ModuleInfo, call: ast.Call) -> ast.Call | None:
        """The ``KernelCandidate(...)`` a ``register(...)`` call
        registers, or None."""
        canon = module.canonical(call.func) or ""
        if last_segment(canon) != "register" or not call.args:
            return None
        inner = call.args[0]
        if isinstance(inner, ast.Call) and last_segment(
                module.canonical(inner.func) or "") == "KernelCandidate":
            return inner
        return None

    @staticmethod
    def _is_cuda_without_plain(cand: ast.Call) -> tuple[bool, bool]:
        """(is a CUDA candidate, has a plain version)."""
        kw = {k.arg: k.value for k in cand.keywords}
        source = kw.get("source")
        cuda = source is None or (isinstance(source, ast.Constant)
                                  and source.value == "cuda")
        ref = kw.get("reference")
        if ref is None and len(cand.args) >= 4:
            ref = cand.args[3]
        plain = ref is not None and not (isinstance(ref, ast.Constant)
                                         and ref.value is None)
        return cuda, plain

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        path = module.path.replace("\\", "/")
        regs = []
        loads = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            cand = self._candidate(module, node)
            if cand is not None:
                regs.append((node, *self._is_cuda_without_plain(cand)))
                continue
            canon = module.canonical(node.func) or ""
            if canon in _PL_LOADERS and "ops/cuda/" in path \
                    or canon.endswith(("ops.cuda.build.load",
                                       "ops.cuda.build.function")):
                loads.append(node)
        for node, cuda, plain in regs:
            if cuda and not plain:
                yield self.finding(
                    module, node,
                    "CUDA kernel candidate registered with no plain torch "
                    "version (`reference=`) — the CPU tests cannot run it "
                    "and chip_smoke.py cannot hold it to anything; "
                    "register its plain version beside it")
        if loads and not any(cuda and plain for _n, cuda, plain in regs):
            yield self.finding(
                module, loads[0],
                "kernel loaded through ops/cuda/build.py in a module that "
                "registers no CUDA candidate with a plain version — every "
                "kernel needs its plain torch version registered beside it")


#: identifier fragments naming an optimizer-state tree
_ZR_STATE_TOKENS = ("tstate", "opt_state")
#: calls that gather sharded blocks to the full layout
_ZR_GATHERS = {"global_block", "all_gather", "all_gather_or_identity",
               "to_natural_host"}
#: the trainer's sanctioned full-layout gathers (the save, the final pull)
_ZR_EXEMPT = {"checkpoint", "final_params"}


def _mentions_token(node: ast.AST, tokens) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and any(t in n.id.lower() for t in tokens):
            return True
        if isinstance(n, ast.Attribute) \
                and any(t in n.attr.lower() for t in tokens):
            return True
    return False


@register
class ZeroReplicateRule(Rule):
    """ZR01 — un-gated gather of ZeRO optimizer state to the full layout.

    Under ``zero_stage >= 1`` each rank keeps its chunk of the optimizer
    state (``ZeroLayout``); gathering a ``tstate``/``opt_state`` tree back
    to the natural (full) layout — ``global_block``, ``all_gather``,
    ``all_gather_or_identity``, ``to_natural_host`` of it, directly or
    through ``tree_map`` over it — re-materializes the whole state on
    every rank, undoing the 1/ndp memory win without failing any numerics
    test.  The save (``checkpoint``) and the final pull (``final_params``)
    are where that gather is the point, and are exempt.  The rule scopes
    itself to functions that read ``zero_stage`` and stays quiet when the
    gather is gated by a ``zero_stage`` conditional: inside any branch of
    an ``if`` whose test mentions ``zero_stage``, or after a
    ``zero_stage`` guard that early-returns.

    Blind spots: gathers routed through a helper defined elsewhere, and
    state trees not named ``*tstate*``/``*opt_state*`` — naming IS the
    contract in this tree.
    """

    id = "ZR01"
    title = "full-layout gather of ZeRO optimizer state"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name not in _ZR_EXEMPT \
                    and _mentions_token(node, ("zero_stage",)):
                yield from self._check_function(module, node)

    # ------------------------------------------------------------- gating
    def _gated_ids(self, fn: ast.AST) -> set[int]:
        """ids of AST nodes covered by a ``zero_stage`` conditional: every
        descendant of any branch of an If whose test reads zero_stage,
        plus statements that only execute after such an If whose taken
        branch leaves the block (early return/raise/continue/break)."""
        gated: set[int] = set()

        def mark(node: ast.AST):
            for n in ast.walk(node):
                gated.add(id(n))

        # every statement list anywhere in the function is one block; a
        # zero_stage If gates its own branches, and (when its taken branch
        # leaves the block) everything after it in the same list
        for n in ast.walk(fn):
            for field in ("body", "orelse", "finalbody"):
                stmts = getattr(n, field, None)
                if isinstance(stmts, list) and stmts \
                        and all(isinstance(s, ast.stmt) for s in stmts):
                    behind = False
                    for s in stmts:
                        if behind:
                            mark(s)
                            continue
                        if isinstance(s, ast.If) and _mentions_token(
                                s.test, ("zero_stage",)):
                            for sub in s.body + s.orelse:
                                mark(sub)
                            if s.body and isinstance(
                                    s.body[-1], (ast.Return, ast.Raise,
                                                 ast.Continue, ast.Break)):
                                behind = True
        return gated


    def _gathers(self, module: ModuleInfo, node: ast.AST) -> list:
        return [c for c in _calls_in(node)
                if last_segment(module.canonical(c.func)
                                or dotted_name(c.func) or "") in _ZR_GATHERS]

    def _check_function(self, module: ModuleInfo,
                        fn: ast.FunctionDef) -> Iterator[Finding]:
        gated = self._gated_ids(fn)
        local_defs = {d.name: d for d in ast.walk(fn)
                      if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef))
                      and d is not fn}
        for call in _calls_in(fn):
            if id(call) in gated:
                continue
            seg = last_segment(module.canonical(call.func)
                               or dotted_name(call.func) or "")
            if seg in _ZR_GATHERS and call.args \
                    and _mentions_token(call.args[0], _ZR_STATE_TOKENS):
                yield self._fire(module, call)
            elif seg == "tree_map" and len(call.args) >= 2 and any(
                    _mentions_token(a, _ZR_STATE_TOKENS)
                    for a in call.args[1:]):
                # tree_map(gather_fn, tstate): the gather lives in the
                # mapped function (a lambda or a local def)
                mapped = call.args[0]
                if isinstance(mapped, ast.Name) and mapped.id in local_defs:
                    mapped = local_defs[mapped.id]
                if self._gathers(module, mapped):
                    yield self._fire(module, call)

    def _fire(self, module: ModuleInfo, node: ast.AST) -> Finding:
        return self.finding(
            module, node,
            "gather of an optimizer-state tree to the full layout in "
            "zero_stage-aware code, outside checkpoint/final_params and "
            "with no `zero_stage` gate — under zero_stage >= 1 this "
            "re-materializes the whole state on every rank, silently "
            "undoing the 1/ndp ZeRO memory win; keep the rank's chunks "
            "(or gather only in the save)")


# ------------------------------------------------------------------ LK01-TH01

@register
class UnguardedSharedWriteRule(Rule):
    """LK01: an attribute the class treats as lock-guarded is written
    without the lock — or is written from two thread contexts with no
    lock at all.

    Three triggers, in priority order:

    1. **declared contract**: any assignment line carrying a
       ``# guarded-by: self._lock`` comment makes every later write of
       that attribute outside ``with self._lock:`` a finding;
    2. **majority inference**: when at least half of an attribute's
       non-``__init__`` writes hold some lock, the unlocked minority are
       the bug (a step timer raced exactly this way);
    3. **shared-context inference**: in a class that spawns threads or
       handles HTTP, an attribute written both from a thread-entry
       context (``Thread(target=...)`` closure, ``do_GET``) and from
       caller-facing methods, with no write ever locked, is a data race
       waiting for load.  One finding per attribute, anchored at the
       first unlocked write.

    Blind spots: reads are not tracked; ``acquire()``/``release()``
    pairs are invisible (use ``with``); aliasing (``s = self.slots``)
    hides writes; happens-before edges that are real but invisible to
    the AST (warmup-before-start) need an inline suppression with the
    reason spelled out.
    """

    id = "LK01"
    title = "unguarded write to lock-guarded/thread-shared attribute"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        model = module_concurrency(module)
        for cls in model.classes:
            yield from self._check_class(module, cls)

    def _check_class(self, module: ModuleInfo,
                     cls) -> Iterator[Finding]:
        for attr in sorted(cls.writes):
            body = [w for w in cls.writes[attr]
                    if w.method not in _INIT_METHODS]
            if not body:
                continue
            body.sort(key=lambda w: getattr(w.node, "lineno", 0))
            lock = cls.guarded_by.get(attr)
            if lock is not None:
                for w in body:
                    if lock not in w.held:
                        yield self.finding(
                            module, w.node,
                            f"write to `self.{attr}` in `{cls.name}."
                            f"{w.method}` without holding `self.{lock}` "
                            f"(declared `# guarded-by: self.{lock}`)")
                continue
            unlocked = [w for w in body if not w.held]
            locked = [w for w in body if w.held]
            if not unlocked:
                continue
            if locked and len(locked) >= len(unlocked):
                guard = Counter(
                    l for w in locked for l in w.held).most_common(1)[0][0]
                others = ", ".join(
                    f"{w.method}:{getattr(w.node, 'lineno', '?')}"
                    for w in unlocked[1:]) or "none"
                yield self.finding(
                    module, unlocked[0].node,
                    f"`self.{attr}` is written under `self.{guard}` in "
                    f"{len(locked)} of {len(body)} sites but not in "
                    f"`{cls.name}.{unlocked[0].method}` (other unlocked "
                    f"sites: {others}) — take the lock, or annotate the "
                    f"deliberate exception with a reason")
            elif cls.threaded:
                ctxs = set()
                for w in body:
                    ctxs |= cls.contexts(w.method)
                if len(ctxs) >= 2:
                    roots = ", ".join(sorted(ctxs))
                    sites = ", ".join(sorted(
                        {f"{w.method}:{getattr(w.node, 'lineno', '?')}"
                         for w in body}))
                    yield self.finding(
                        module, unlocked[0].node,
                        f"`self.{attr}` is written from multiple thread "
                        f"contexts ({roots}; sites {sites}) with no lock "
                        f"ever held in `{cls.name}` — guard it (declare "
                        f"`# guarded-by: self._lock` and wrap writes in "
                        f"`with self._lock:`) or suppress with the "
                        f"happens-before argument spelled out")


@register
class LockOrderRule(Rule):
    """LK02: the module's static lock-order graph has a cycle.

    Nested ``with`` acquisitions and one level of ``self.m()`` helper
    propagation yield ``held -> acquired`` edges; any cycle is a
    schedule where two threads deadlock (or, for a length-1 cycle on a
    non-reentrant ``threading.Lock``, one thread deadlocks itself
    through a helper that re-takes the lock it already holds).

    Blind spots: cross-module cycles (lock identities are
    ``Class.attr``-scoped per module), ``acquire()`` call pairs, and
    locks passed as arguments.
    """

    id = "LK02"
    title = "inconsistent lock-acquisition order (deadlock schedule)"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        model = module_concurrency(module)
        for cyc in find_cycles(model.edges):
            e = cyc[0]
            if len(cyc) == 1 and e.held == e.acquired:
                yield self.finding(
                    module, e.node,
                    f"`{e.acquired}` is a non-reentrant Lock already held "
                    f"in `{e.func}` when it is re-acquired — guaranteed "
                    f"self-deadlock; use RLock or hoist the helper's "
                    f"locking to the caller")
                continue
            path = " -> ".join([c.held for c in cyc] + [cyc[0].held])
            where = "; ".join(
                f"{c.held}->{c.acquired} in {c.func}:"
                f"{getattr(c.node, 'lineno', '?')}" for c in cyc)
            yield self.finding(
                module, e.node,
                f"lock-order cycle {path} ({where}) — two threads taking "
                f"these paths concurrently deadlock; pick one global "
                f"order and re-nest the minority site")


@register
class BlockingUnderLockRule(Rule):
    """LK03: a call that can block indefinitely runs while a lock is
    held — every other thread needing that lock convoys behind device
    work, socket I/O, or an untimed wait (and if the blocked operation
    itself needs the lock to make progress, it is a deadlock).

    Condition-variable waits on the *same* lock being held are exempt
    (``wait`` releases its own lock); timed waits/joins/gets are exempt
    (bounded convoy).  Blind spots: blocking hidden behind helper
    functions, and ``dict.get(key)``-vs-``queue.get()`` is told apart
    only by argument count.
    """

    id = "LK03"
    title = "blocking call while holding a lock"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        model = module_concurrency(module)
        for node, why, func in model.blocking:
            yield self.finding(
                module, node,
                f"{why} while holding a lock in `{func}` — threads "
                f"contending for the lock convoy behind this call (a "
                f"deadlock if the blocked work needs the same lock); "
                f"move it outside the `with`, or bound it with a timeout")


@register
class ThreadLifecycleRule(Rule):
    """TH01: a ``threading.Thread`` is created with neither
    ``daemon=True`` nor any visible join/daemon lifecycle.

    A non-daemon thread with no ``join()`` keeps the interpreter alive
    after ``main`` returns — test runs and CLI tools hang on exit, and
    there is no orderly shutdown path.  Accepted lifecycles: a
    ``daemon=True`` kwarg, a later ``<name>.daemon = True`` assignment
    or ``setDaemon(True)`` call, or a ``.join(...)`` on the variable (or
    attribute basename) the thread was assigned to — including threads
    built in a comprehension bound to a container that is then joined
    through a loop variable (``ts = [Thread(...) ...]`` /
    ``for t in ts: t.join()``).

    Blind spots: ``Thread`` subclasses instantiated by their own name,
    and joins that live in another module.
    """

    id = "TH01"
    title = "thread without daemon flag or join lifecycle"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        joined: set[str] = set()
        daemonized: set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute):
                recv = dotted_name(node.func.value)
                if recv and node.func.attr == "join":
                    joined.add(last_segment(recv))
                if recv and node.func.attr == "setDaemon":
                    daemonized.add(last_segment(recv))
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    name = dotted_name(t)
                    if name and last_segment(name) == "daemon":
                        owner = name.rsplit(".", 2)
                        if len(owner) >= 2:
                            daemonized.add(owner[-2])
        # a container joined through a loop variable counts: the loop var
        # landed in `joined` above, so lift that onto the iterated name
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)) \
                    and isinstance(node.target, ast.Name):
                src = dotted_name(node.iter)
                if src:
                    if node.target.id in joined:
                        joined.add(last_segment(src))
                    if node.target.id in daemonized:
                        daemonized.add(last_segment(src))
        compound = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                    ast.For, ast.AsyncFor, ast.While, ast.If, ast.Try,
                    ast.With, ast.AsyncWith)
        for stmt in body_statements(module.tree.body, into_defs=True):
            if isinstance(stmt, compound):
                continue       # its simple statements are enumerated anyway
            for call, bound in self._thread_calls(module, stmt):
                kw = {k.arg: k.value for k in call.keywords}
                d = kw.get("daemon")
                if d is not None and not (
                        isinstance(d, ast.Constant) and d.value is False):
                    continue
                base = last_segment(bound) if bound else None
                if base and (base in joined or base in daemonized):
                    continue
                held = f"bound to `{bound}`" if bound else "never bound"
                yield self.finding(
                    module, call,
                    f"thread created without `daemon=True` and with no "
                    f"visible `join()`/daemon lifecycle ({held}) — it "
                    f"outlives main and hangs interpreter shutdown; pass "
                    f"`daemon=True` or join it on the shutdown path")

    @staticmethod
    def _thread_calls(module: ModuleInfo, stmt: ast.stmt):
        """(Thread(...) call, dotted name it is assigned to | None)."""
        bound_ids: dict[int, str] = {}
        if isinstance(stmt, ast.Assign):
            names = [n for t in stmt.targets for n in assigned_names(t)]
            if names and isinstance(stmt.value, ast.Call):
                bound_ids[id(stmt.value)] = names[0]
            elif names and isinstance(stmt.value, (ast.ListComp, ast.SetComp,
                                                   ast.GeneratorExp)):
                # threads built in a comprehension are "bound to" the
                # container the comprehension is assigned to
                for sub in ast.walk(stmt.value):
                    if isinstance(sub, ast.Call):
                        bound_ids[id(sub)] = names[0]
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) and node is not stmt:
                continue
            if isinstance(node, ast.Call):
                canon = module.canonical(node.func) or ""
                if canon == "threading.Thread" or canon.endswith(".Thread"):
                    yield node, bound_ids.get(id(node))


#: PagePool methods that hand the caller page references it must release
_PG_ACQUIRE = {"alloc", "incref", "lookup_prefix"}
#: methods that give references back (any one on an exit path clears PG01)
#: — decref_quarantine is the off-serve-thread release (migration abort):
#: it drops the reference without making the page allocatable, which is
#: still a release for leak purposes
_PG_RELEASE = {"decref", "decref_quarantine", "free", "release", "reset"}


@register
class PageLeakRule(Rule):
    """PG01: KV pages acquired from a page pool with no release on the
    failure exit paths.

    The paged serving engine's pages are refcounted host-side
    (serving/paging.py): every ``alloc``/``lookup_prefix``/``incref``
    hands the caller references it MUST give back with ``decref`` on
    every exit path — including the exceptional ones.  A bare acquire
    that can unwind past its caller leaks pinned pages: the pool's free
    list shrinks permanently and admission starts 429ing long before the
    device pool is actually full (the refcount twin of a file-descriptor
    leak).  The engine's own discipline is acquire-inside-``try`` with
    ``decref`` in the handler or ``finally`` (see ``_admit``/``warmup``).

    Fires on an acquire-method call whose receiver looks pool-ish (its
    dotted name mentions ``pool``/``paging``) when no enclosing ``try``
    has a release call in its handlers or ``finally``.  Scoped to
    ``serving/`` modules — that is where the pool contract lives.
    ``self.<acquire>`` is exempt: those are the pool's own internals,
    whose invariants the pool lock already owns.

    Blind spots: a pool aliased to a name without ``pool`` in it; a
    release performed by a callee the handler delegates to (name the
    release in the handler, or silence with a reason).
    """

    id = "PG01"
    title = "KV page acquire without release on exit paths"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if "serving/" not in module.path.replace("\\", "/"):
            return
        parents: dict[int, ast.AST] = {}
        for node in ast.walk(module.tree):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _PG_ACQUIRE):
                continue
            recv = dotted_name(node.func.value) or ""
            low = recv.lower()
            if recv == "self" or not ("pool" in low or "paging" in low):
                continue
            if self._released_on_unwind(node, parents):
                continue
            yield self.finding(
                module, node,
                f"`{recv}.{node.func.attr}` acquires KV page references "
                "with no release on the exceptional exit path — an "
                "unwind here leaks pinned pages and the pool 429s "
                "forever after; wrap in try/except-or-finally that "
                "`decref`s what was acquired")

    @staticmethod
    def _released_on_unwind(call: ast.Call, parents) -> bool:
        """True when an enclosing ``try`` releases pages in a handler or
        ``finally`` (walking out stops at the enclosing function)."""
        node: ast.AST = call
        while True:
            parent = parents.get(id(node))
            if parent is None or isinstance(
                    parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
                return False
            if isinstance(parent, ast.Try):
                cleanup = list(parent.finalbody)
                for h in parent.handlers:
                    cleanup.extend(h.body)
                for stmt in cleanup:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call) \
                                and isinstance(sub.func, ast.Attribute) \
                                and sub.func.attr in _PG_RELEASE:
                            return True
            node = parent


@register
class UnregisteredTimingRule(Rule):
    """OB01 — hand-rolled dispatch timing that bypasses the registry.

    A function in ``serving/`` or ``parallel/`` that reads
    ``time.monotonic()``/``time.perf_counter()`` around a device-
    dispatching call but never reports through the observability layer
    (``METRICS``/``trace``/``record_span``) produces a measurement that
    exists nowhere: no histogram, no ``/metrics.prom`` scrape, no trace
    event.  The tracing/MFU accounting derives everything from
    registry observations — a private clock read next to a dispatch is
    the sign a hot path grew its own timing instead of feeding the
    registry.  One registry or
    tracer call anywhere in the function satisfies the rule, exactly
    like HOT02.

    Blind spots: a clock read in one function passed to a helper that
    times/dispatches in another; a dispatch hidden behind an attribute
    the jit-facts pass cannot resolve.  Silence deliberate raw timing
    with ``# graftlint: disable=OB01`` plus the reason.
    """

    id = "OB01"
    title = "dispatch timing bypasses the observability registry"

    _CLOCKS = {"time.monotonic", "time.monotonic_ns",
               "time.perf_counter", "time.perf_counter_ns"}

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        path = module.path.replace("\\", "/")
        if "serving/" not in path and "parallel/" not in path:
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if UninstrumentedHotLoopRule._has_obs(node, module):
                continue
            clock = None
            for call in _calls_in(node):
                name = (module.canonical(call.func)
                        or dotted_name(call.func) or "")
                if name in self._CLOCKS:
                    clock = call
                    break
            if clock is None:
                continue
            dispatches = None
            for call in _calls_in(node):
                callee = dotted_name(call.func)
                if callee and module.is_dispatching_call(callee, call):
                    dispatches = callee
                    break
            if dispatches is None:
                continue
            yield self.finding(
                module, clock,
                f"function times device dispatch ({dispatches!r}) with a "
                "raw monotonic/perf_counter read and never reports through "
                "METRICS/trace — the measurement is invisible to scrapes "
                "and traces; record it via METRICS.observe_time/time() or "
                "trace.record_span (or silence with a reason)")



@register
class RawQuantCastRule(Rule):
    """QT01 — ad-hoc KV/weight precision casts outside the quant helpers.

    ``x.to(torch.int8)`` wraps on overflow (300 → 44) and a cast to
    ``torch.float8_*`` rounds with no absmax scaling — neither is a
    quantization.  Every sound low-precision write in this tree goes
    through a helper that scales THEN saturates (``ops/cuda/kv_quant``
    for cache pages, ``ops/cuda/matmul_int8.quantize`` for weights),
    which is also where the paired scale tensor is produced.  A raw cast
    in ``serving/`` or ``models/`` means a value reached storage precision
    without a scale beside it.  Fires on ``.to(...)``/``.type(...)``
    whose dtype (positional or ``dtype=``) is ``int8`` or an fp8 dtype;
    scoped to those two trees (the helpers in ``ops/cuda/`` are the one
    place a raw cast is the point).

    Blind spots: a dtype smuggled through a variable
    (``dt = torch.int8; x.to(dt)``); ``torch.tensor(x, dtype=torch.int8)``.
    Silence a deliberate storage-layer cast with
    ``# graftlint: disable=QT01`` plus the reason.
    """

    id = "QT01"
    title = "raw int8/fp8 cast outside the quant helpers"

    _QUANT_DTYPES = {"torch.int8", "numpy.int8"}

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        path = module.path.replace("\\", "/")
        if "serving/" not in path and "models/" not in path:
            return
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("to", "type")):
                continue
            args = list(node.args) + [kw.value for kw in node.keywords
                                      if kw.arg == "dtype"]
            for arg in args:
                name = (module.canonical(arg) or dotted_name(arg) or "")
                seg = last_segment(name) or ""
                if name in self._QUANT_DTYPES or seg.startswith("float8_"):
                    yield self.finding(
                        module, node,
                        f"raw `.{node.func.attr}({seg})` — an unscaled, "
                        "unsaturated cast to storage precision (int8 wraps "
                        "on overflow, fp8 rounds with no absmax); quantize "
                        "through `kv_quant` or `matmul_int8.quantize` so a "
                        "scale rides beside the bytes (or silence with a "
                        "reason)")
                    break


@register
class ElasticMeshConstructionRule(Rule):
    """EL01 — mesh/process-group construction outside the mesh helpers.

    Elastic training rebuilds the mesh at runtime: a rank loss shrinks
    it, a re-registration grows it, and a resharding restore re-splits
    state onto whatever width came out.  That only works when every mesh
    and process group in ``parallel/``/``resilience/`` flows through the
    ``parallel/mesh.py`` helpers (``make_mesh``/``local_mesh``/
    ``elastic_mesh``/``shrink_mesh``/``grow_mesh``,
    ``initialize_multihost``), which create groups in one order on every
    rank and keep the axis layout canonical.  A raw ``Mesh(...)``, a
    ``dist.new_group(...)`` or an ``init_process_group(...)`` elsewhere
    builds a group the resize path can neither rebuild nor verify — and
    a ``new_group`` made on some ranks only hangs the world.  A
    ``rank_devices()`` subscript with *integer-literal* bounds
    (``rank_devices()[:8]``) hard-codes a device set the same way;
    variable-bounded slices are fine.  Scoped to ``parallel/`` and
    ``resilience/`` excluding ``mesh.py`` itself (the one sanctioned
    construction site); ``NamedSharding`` over an existing mesh is not
    construction and is not flagged.

    Blind spots: a constructor aliased through a variable, and device
    lists materialized in another module and passed in.  Silence a
    deliberate fixed topology with ``# graftlint: disable=EL01`` plus
    the reason.
    """

    id = "EL01"
    title = "raw mesh/group construction outside parallel/mesh.py helpers"

    _CONSTRUCTORS = {"Mesh", "new_group", "init_process_group"}
    _DEVICE_ENUMS = {"rank_devices"}

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        path = module.path.replace("\\", "/")
        if "parallel/" not in path and "resilience/" not in path:
            return
        if path.endswith("parallel/mesh.py"):
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                canon = (module.canonical(node.func)
                         or dotted_name(node.func) or "")
                seg = last_segment(canon) or canon
                if seg in self._CONSTRUCTORS:
                    yield self.finding(
                        module, node,
                        f"raw `{seg}(...)` outside `parallel/mesh.py` — the "
                        "elastic resize path (shrink/grow/reshard) can only "
                        "rebuild meshes and groups made by the helpers; use "
                        "`make_mesh`/`local_mesh`/`elastic_mesh`/"
                        "`initialize_multihost` (or silence with a reason)")
            elif isinstance(node, ast.Subscript):
                v = node.value
                if not isinstance(v, ast.Call):
                    continue
                canon = (module.canonical(v.func)
                         or dotted_name(v.func) or "")
                if last_segment(canon) not in self._DEVICE_ENUMS:
                    continue
                if self._literal_bounds(node.slice):
                    yield self.finding(
                        module, node,
                        f"`{canon}()` subscripted with integer-literal "
                        "bounds hard-codes a device set — after a "
                        "shrink/grow the literal is stale and the slice "
                        "silently picks the wrong ranks; derive the "
                        "width from the mesh (or a parameter) and build "
                        "through `elastic_mesh`/`make_mesh`")

    @staticmethod
    def _literal_bounds(sl: ast.AST) -> bool:
        """True for ``[3]`` / ``[:8]`` / ``[2:6]``; False when every
        bound is a name/expression the caller computes (``[:n]``)."""
        if isinstance(sl, ast.Constant) and isinstance(sl.value, int):
            return True
        if isinstance(sl, ast.Slice):
            return any(isinstance(b, ast.Constant)
                       and isinstance(b.value, int)
                       for b in (sl.lower, sl.upper))
        return False




@register
class UndocumentedMetricNameRule(Rule):
    """OB02 — a metric name absent from the documented metrics tables.

    Every scrape consumer (``metrics_dump``, the perf gate, the SLO
    evaluator, dashboards) binds to metric names by string, and names
    drift from the docs after the fact.  This rule closes the loop at
    lint time: a literal first argument to
    ``METRICS.increment/gauge/observe_time/observe_many/time`` (or the
    same mutators on a ``registry``) must appear in a metrics table row
    of ``README.md``/``DESIGN.md`` — rows shaped
    ``| `name` | counter/gauge/timer | description |``.  Documented rows
    may carry ``<placeholder>``/``{placeholder}``/``*`` suffixes
    (``faults.injected.<site>``): they match any name sharing the
    literal prefix.  F-strings and string concatenations are checked by
    their leading literal against those wildcard rows; names with no
    leading literal at all are runtime-composed and out of scope.

    Blind spots: names built through variables or ``str.join``; a
    mutator reached through a receiver not named ``METRICS``/
    ``registry``; a too-short f-string prefix that several wildcard
    rows cover.  Silence a deliberately undocumented (e.g. test-only)
    name with ``# graftlint: disable=OB02`` plus the reason.
    """

    id = "OB02"
    title = "metric name missing from the documented metrics tables"

    _MUTATORS = {"increment", "gauge", "observe_time", "observe_many",
                 "time"}
    _RECEIVERS = {"METRICS", "registry"}
    _DOC_FILES = ("README.md", "DESIGN.md")
    _ROW = re.compile(
        r"\s*\|\s*`([^`]+)`\s*\|\s*(?:counter|gauge|timer|histogram)s?\b")
    _cache: tuple[frozenset, tuple] | None = None
    _override: tuple[frozenset, tuple] | None = None

    # ------------------------------------------------------- documented set
    @classmethod
    def set_documented(cls, names) -> None:
        """Test hook: replace the parsed doc tables (None restores)."""
        cls._override = None if names is None else cls._split(names)

    @staticmethod
    def _split(names) -> tuple[frozenset, tuple]:
        exact, prefixes = set(), []
        for n in names:
            m = re.search(r"[<{*]", n)
            if m:
                prefixes.append(n[:m.start()])
            else:
                exact.add(n)
        return frozenset(exact), tuple(prefixes)

    @classmethod
    def documented(cls) -> tuple[frozenset, tuple]:
        if cls._override is not None:
            return cls._override
        if cls._cache is None:
            root = pathlib.Path(__file__).resolve().parents[2]
            names: list[str] = []
            for fn in cls._DOC_FILES:
                p = root / fn
                if p.exists():
                    for line in p.read_text().splitlines():
                        m = cls._ROW.match(line)
                        if m:
                            names.append(m.group(1))
            cls._cache = cls._split(names)
        return cls._cache

    # --------------------------------------------------------------- check
    @staticmethod
    def _literal_name(arg) -> tuple[str | None, bool]:
        """(name, is_prefix_only): a Constant is the full name; an
        f-string / ``"lit" + var`` concat yields its leading literal."""
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value, False
        if isinstance(arg, ast.JoinedStr) and arg.values:
            head = arg.values[0]
            if isinstance(head, ast.Constant) and isinstance(head.value, str) \
                    and head.value:
                return head.value, True
        if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add) \
                and isinstance(arg.left, ast.Constant) \
                and isinstance(arg.left.value, str) and arg.left.value:
            return arg.left.value, True
        return None, False

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        exact, prefixes = self.documented()
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._MUTATORS):
                continue
            recv = dotted_name(node.func.value) or ""
            if (last_segment(recv) or recv) not in self._RECEIVERS:
                continue
            arg = node.args[0] if node.args else None
            if arg is None:
                for kw in node.keywords:
                    if kw.arg == "name":
                        arg = kw.value
            if arg is None:
                continue
            name, prefix_only = self._literal_name(arg)
            if name is None:
                continue
            if prefix_only:
                if any(name.startswith(p) or p.startswith(name)
                       for p in prefixes):
                    continue
            elif name in exact or any(name.startswith(p) for p in prefixes):
                continue
            yield self.finding(
                module, node,
                f"metric name `{name}{'…' if prefix_only else ''}` is not "
                "in the documented metrics tables (README.md/DESIGN.md) — "
                "scrape consumers bind to names by string, so undocumented "
                "names drift silently; add a "
                "`| `name` | kind | description |` row (wildcard "
                "placeholders allowed) or silence with a reason")


@register
class UnboundedMetricCardinalityRule(Rule):
    """OB03 — request-derived data interpolated into a metric name.

    The registry keys counters/gauges/histograms by name forever: a
    metric name built from a tenant id, request id, session id, or
    prompt-derived string mints one immortal series per distinct value —
    unbounded cardinality, i.e. a memory leak the dashboard renders
    proudly.  The ONE sanctioned path from request-derived strings to
    metric names is ``observability/fleet.py``'s ``TenantLabels``: it
    folds everything beyond the tracked top-K into ``__other__``, so the
    series set stays bounded by construction.  That module is exempt;
    everywhere else, an f-string or concatenation passed to
    ``METRICS.increment/gauge/observe_time/observe_many/time`` (or the
    same mutators on a ``registry``) whose interpolated parts reference
    a request-derived identifier — a name, attribute, subscript key, or
    ``.get("...")`` key in the tenant/request/session/user/prompt
    family — fails here.

    Blind spots: names composed through intermediate variables
    (``n = f"x.{tenant}"; METRICS.increment(n)``), identifiers renamed
    before interpolation (``t = req.tenant``... ``f"x.{t}"``), and
    ``str.join``/``%``/``.format`` composition.  Silence a
    deliberately-bounded interpolation (e.g. a fixed enum) with
    ``# graftlint: disable=OB03`` plus the reason.
    """

    id = "OB03"
    title = "request-derived data interpolated into a metric name"

    _MUTATORS = UndocumentedMetricNameRule._MUTATORS
    _RECEIVERS = UndocumentedMetricNameRule._RECEIVERS
    _REQUEST_DERIVED = frozenset({
        "tenant", "tenant_id", "tenants", "request_id", "req_id",
        "trace_id", "prompt", "user", "user_id", "session", "session_id"})
    _EXEMPT_SUFFIX = "observability/fleet.py"  # the bounded label helper

    @classmethod
    def _dynamic_identifiers(cls, arg) -> set[str]:
        """Lower-cased identifiers referenced by the NON-literal parts
        of an interpolated metric-name expression."""
        dyn: list[ast.AST] = []
        if isinstance(arg, ast.JoinedStr):
            dyn = [v.value for v in arg.values
                   if isinstance(v, ast.FormattedValue)]
        elif isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add):
            stack: list[ast.AST] = [arg]
            while stack:
                n = stack.pop()
                if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Add):
                    stack.extend((n.left, n.right))
                elif not isinstance(n, ast.Constant):
                    dyn.append(n)
        out: set[str] = set()
        for d in dyn:
            for sub in ast.walk(d):
                if isinstance(sub, ast.Name):
                    out.add(sub.id.lower())
                elif isinstance(sub, ast.Attribute):
                    out.add(sub.attr.lower())
                elif isinstance(sub, ast.Subscript):
                    sl = sub.slice
                    if isinstance(sl, ast.Constant) \
                            and isinstance(sl.value, str):
                        out.add(sl.value.lower())
                elif isinstance(sub, ast.Call):
                    # payload.get("tenant") — the key names the data
                    for a in sub.args:
                        if isinstance(a, ast.Constant) \
                                and isinstance(a.value, str):
                            out.add(a.value.lower())
        return out

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if module.path.replace("\\", "/").endswith(self._EXEMPT_SUFFIX):
            return
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._MUTATORS):
                continue
            recv = dotted_name(node.func.value) or ""
            if (last_segment(recv) or recv) not in self._RECEIVERS:
                continue
            arg = node.args[0] if node.args else None
            if arg is None:
                for kw in node.keywords:
                    if kw.arg == "name":
                        arg = kw.value
            if arg is None:
                continue
            hits = sorted(self._dynamic_identifiers(arg)
                          & self._REQUEST_DERIVED)
            if hits:
                yield self.finding(
                    module, node,
                    f"metric name interpolates request-derived data "
                    f"({', '.join(hits)}) — every distinct value mints an "
                    "immortal registry series (unbounded cardinality); "
                    "route per-tenant accounting through "
                    "`observability.fleet.TenantLabels` (top-K exact, "
                    "`__other__` fold) instead of building the name here")


@register
class OnlineDurableWriteRule(Rule):
    """OL01 — non-durable rewrite on the online-loop / publish path.

    The online learning loop's durability story (DESIGN.md §23) has
    exactly two sanctioned write shapes: *append-only fsync'd logs* (the
    capture store — ``open(..., "a")`` plus ``os.fsync``, where a crash
    costs at most the torn tail replay already tolerates) and
    *unique-tempfile + fsync + atomic ``os.replace``* for anything
    rewritten in place (checkpoint payloads, manifests, poison/repair
    tooling).  A bare ``open(path, "w")`` / ``write_text`` /
    ``write_bytes`` on these paths is a torn-file publisher: a crash (or
    injected ``corrupt_file``) mid-write leaves a half-written file at
    the FINAL name, where a concurrent reader — the serving reload, the
    replay, ``latest_valid_step()`` — picks it up as truth.

    Fires on truncating opens (mode containing ``w`` or ``x``, incl.
    ``os.fdopen``) and ``write_text``/``write_bytes`` calls in modules
    under ``online/`` or in ``parallel/checkpoint.py``, unless the
    enclosing function visibly carries the idiom: a call to
    ``os.replace`` AND durability evidence (``os.fsync``, an
    ``*fsync*``-named helper, or a ``tempfile.mkstemp``/``mkdtemp``/
    ``NamedTemporaryFile`` unique target).  Append-mode opens are exempt
    (the log-structured contract).

    Blind spots: writers behind helpers in other modules (``np.savez``
    onto a final path — route it at a tempfile), modes built at runtime,
    and idiom halves split across functions (keep open→fsync→replace in
    ONE function so a reader — and this rule — can see the whole
    contract).  Silence a deliberate non-durable write with
    ``# graftlint: disable=OL01`` plus the reason.
    """

    id = "OL01"
    title = "non-durable rewrite on the online/checkpoint publish path"

    _WRITE_ATTRS = {"write_text", "write_bytes"}
    _TMP_CALLS = {"tempfile.mkstemp", "tempfile.mkdtemp",
                  "tempfile.NamedTemporaryFile", "mkstemp", "mkdtemp",
                  "NamedTemporaryFile"}

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        path = module.path.replace("\\", "/")
        if "/online/" not in path and not path.startswith("online/") \
                and not path.endswith("parallel/checkpoint.py"):
            return
        parents: dict[int, ast.AST] = {}
        for node in ast.walk(module.tree):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            label = self._rewrite_label(module, node)
            if label is None:
                continue
            fn = self._enclosing_function(node, parents)
            if fn is not None and self._has_idiom(module, fn):
                continue
            yield self.finding(
                module, node,
                f"`{label}` rewrites a file on the online/checkpoint "
                "publish path without the unique-tempfile + fsync + "
                "`os.replace` idiom — a crash mid-write publishes a torn "
                "file under the final name; write to a `tempfile` "
                "sibling, fsync it, then `os.replace` onto the target "
                "(appends to fsync'd logs are the one exemption)")

    def _rewrite_label(self, module: ModuleInfo, call: ast.Call) -> str | None:
        """A display label when ``call`` truncates/rewrites a file."""
        canon = module.canonical(call.func) or dotted_name(call.func) or ""
        if canon in ("open", "os.fdopen"):
            mode = None
            if len(call.args) >= 2:
                mode = call.args[1]
            for kw in call.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
                    and any(c in mode.value for c in "wx")):
                return f'{canon}(..., "{mode.value}")'
            return None
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in self._WRITE_ATTRS):
            recv = dotted_name(call.func.value) or "<expr>"
            return f"{recv}.{call.func.attr}"
        return None

    @staticmethod
    def _enclosing_function(node: ast.AST, parents) -> ast.AST | None:
        while node is not None:
            node = parents.get(id(node))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return node
        return None

    def _has_idiom(self, module: ModuleInfo, fn: ast.AST) -> bool:
        """True when ``fn`` visibly replaces atomically AND shows
        durability evidence (fsync or a unique tempfile target)."""
        has_replace = False
        has_durable = False
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            canon = module.canonical(sub.func) or dotted_name(sub.func) or ""
            name = last_segment(canon) or canon
            if canon == "os.replace" or name == "replace" and \
                    canon.startswith("os."):
                has_replace = True
            if canon == "os.fsync" or "fsync" in name.lower() \
                    or canon in self._TMP_CALLS:
                has_durable = True
            if has_replace and has_durable:
                return True
        return False


# ------------------------------------------------------------- sharding tier
#
# SH01-SH02 + NM01 consume the analysis/sharding.py mesh-axis pass: axis
# bindings resolved interprocedurally from mesh construction through the
# ``with mesh:`` blocks the collectives resolve against, and the canonical
# axis registry parsed out of parallel/mesh.py.  The runtime twin is
# analysis/shardguard.py (placement drift on live step dispatches) — same
# split as the concurrency tier's LK rules/lockguard.


@register
class UnboundCollectiveAxisRule(Rule):
    """SH01 — collective over an axis no enclosing mesh context binds.

    ``clv.psum(x, "tp")`` inside a ``with mesh:`` over a ``("dp",)`` mesh
    cannot do what it says: ``parallel/collectives.py`` resolves the axis
    against the active mesh, and an axis the mesh lacks (or holds one
    wide) makes the collective the identity — the reduction silently
    never happens.  The sharding pass resolves which axes each collective
    is bound under (``Mesh``/``make_mesh``/``local_mesh``/
    ``elastic_mesh`` assignments, the ``with`` blocks that activate them,
    plus one module-internal call level of propagation) and this rule
    fires when a collective's literal/constant axis argument is missing
    from that KNOWN set.

    Deliberately confidence-ranked: an axis arriving as a function
    parameter (the collectives' own wrappers), a mesh the pass cannot
    resolve (``with self.mesh:``), or a collective outside any visible
    ``with mesh:`` all leave the binding unknown and keep the rule
    silent — cross-module mesh flow is the blind spot, and why
    suppressions exist.
    """

    id = "SH01"
    title = "collective over an axis not bound by the enclosing mesh context"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        info = sharding_info(module)
        for call, chain in info.collective_chains.items():
            axis_arg = info.collective_axis_arg(call)
            if axis_arg is None:
                continue
            axes_named = info.resolve_axis_tuple(axis_arg)
            if axes_named is None:
                continue
            bound = info.axes_for_chain(chain)
            if bound is None:
                continue
            missing = [a for a in axes_named if a not in bound]
            if missing:
                op = last_segment(module.canonical(call.func) or "") or "?"
                yield self.finding(
                    module, call,
                    f"collective `{op}` over axis {missing[0]!r} but the "
                    f"enclosing `with mesh:` context only binds "
                    f"{sorted(bound)} — an axis the active mesh lacks makes "
                    "the collective the identity (nothing is reduced); "
                    "bind the axis in the mesh or fix the name")


@register
class UnknownAxisNameRule(Rule):
    """SH02 — ``PartitionSpec``/``P`` naming an axis outside the registry.

    Every axis name in this repo comes from ONE table — the port's
    ``parallel/mesh.py`` ``DP/TP/PP/SP/EP`` constants and the ``AXES``
    tuple — which the sharding pass parses directly, so the linter and
    the runtime can never disagree about which axes exist.  A literal
    axis string in a ``PartitionSpec``/``P(...)`` call that is not in
    that table is a typo ('dpx'), a stale rename, or an axis no mesh
    helper creates: ``local_block`` then keeps the whole tensor where
    the author meant a block.

    The fix for a true finding is the registry hoist: import the
    constant (``P(DP)``) instead of repeating the string.  Blind spots:
    names built at runtime, specs threaded through variables, and
    constants shadowed locally with non-registry values.
    """

    id = "SH02"
    title = "PartitionSpec axis name absent from the canonical axis registry"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        registry = axis_registry()
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            canon = module.canonical(node.func) or ""
            if last_segment(canon) not in ("PartitionSpec", "P"):
                continue
            for arg in node.args:
                elts = (arg.elts if isinstance(arg, (ast.Tuple, ast.List))
                        else [arg])
                for elt in elts:
                    if not (isinstance(elt, ast.Constant)
                            and isinstance(elt.value, str)):
                        continue
                    if elt.value not in registry:
                        yield self.finding(
                            module, node,
                            f"PartitionSpec axis {elt.value!r} is not in "
                            "the canonical axis registry "
                            f"({', '.join(sorted(registry))}; "
                            "parallel/mesh.py AXES) — no mesh helper "
                            "creates this axis, so the spec silently keeps "
                            "the whole tensor; use the mesh.py constants "
                            "instead of string literals")


@register
class UnstableReductionRule(Rule):
    """NM01 — hand-rolled softmax/logsumexp without max subtraction.

    ``log(sum(exp(x)))`` and ``exp(x)/sum(exp(x))`` overflow to inf the
    moment one logit exceeds ~88 (f32) or ~11 (bf16) — which real logits
    do.  The sanctioned implementations in this tree are the blocked-
    xent kernel (``ops/cuda/xent.py``), the online-softmax attention
    kernels (``ops/cuda/attention.py``, ``ops/cuda/paged_attention.py``)
    and ``torch.logsumexp`` / ``torch.softmax`` — all of which subtract a
    running or global max first.  Scoped to ``ops/``
    and ``models/``, the rule fires on three shapes: direct
    ``log(...sum(exp(...))...)`` nesting, a division whose numerator
    holds ``exp`` and denominator a ``sum`` of ``exp``, and a ``log``/
    division of a local name bound from a sum-of-exp — in each case
    only when the enclosing function shows NO max/clip evidence at all
    (any ``max``/``amax``/``maximum``/``clamp``/``clip``/``logsumexp``/
    ``softmax`` call quiets it, which is what makes the online-softmax
    plain versions pass).

    Blind spots: guards living in a helper the function calls, and
    reductions split across functions.  A deliberately unguarded form
    (inputs bounded by construction) gets ``# graftlint: disable=NM01``
    with the bound stated.
    """

    id = "NM01"
    title = "numerically unstable reduction (softmax/logsumexp w/o max)"

    _GUARDS = {"max", "maximum", "clip", "clamp", "clamp_max", "logsumexp",
               "softmax", "log_softmax", "amax", "nanmax"}

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        path = module.path.replace("\\", "/")
        if not any(seg in path for seg in ("ops/", "models/")):
            return
        for fn in ast.walk(module.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._has_guard(module, fn):
                    continue
                yield from self._check_function(module, fn)

    def _has_guard(self, module: ModuleInfo, fn) -> bool:
        for call in _calls_in(fn):
            canon = module.canonical(call.func) or dotted_name(call.func) or ""
            base = (last_segment(canon) or canon).lstrip("_")
            if base in self._GUARDS:
                return True
        return False

    def _is_exp(self, module: ModuleInfo, call: ast.Call) -> bool:
        canon = module.canonical(call.func) or ""
        return last_segment(canon) == "exp"

    def _contains_exp(self, module: ModuleInfo, node: ast.AST) -> bool:
        return any(self._is_exp(module, c) for c in _calls_in(node))

    def _is_sum_of_exp(self, module: ModuleInfo, node: ast.AST,
                       exp_names=frozenset()) -> bool:
        """``sum(..exp..)`` call or ``(..exp..).sum()`` method call,
        where "exp" is a literal exp call or a name bound from one."""
        if not isinstance(node, ast.Call):
            return False
        name = (node.func.attr if isinstance(node.func, ast.Attribute)
                else last_segment(module.canonical(node.func) or ""))
        if name != "sum":        # torch.sum(e), e.sum(), torch.exp(x).sum()
            return False

        def exppy(n: ast.AST) -> bool:
            return (self._contains_exp(module, n)
                    or bool(names_read(n) & exp_names))

        scope = (node.func.value if isinstance(node.func, ast.Attribute)
                 else None)
        return any(exppy(a) for a in node.args) \
            or (scope is not None and exppy(scope))

    def _contains_sum_of_exp(self, module: ModuleInfo, node: ast.AST,
                             exp_names=frozenset()) -> bool:
        return any(self._is_sum_of_exp(module, n, exp_names)
                   for n in ast.walk(node) if isinstance(n, ast.Call))

    def _check_function(self, module: ModuleInfo, fn) -> Iterator[Finding]:
        # names bound (in this function) to an exp / to a sum-of-exp
        exp_names: set[str] = set()
        sumexp_names: set[str] = set()
        for stmt in body_statements(fn.body):
            if not isinstance(stmt, ast.Assign):
                continue
            if self._contains_sum_of_exp(module, stmt.value, exp_names):
                for target in stmt.targets:
                    sumexp_names.update(assigned_names(target))
            elif self._contains_exp(module, stmt.value):
                for target in stmt.targets:
                    exp_names.update(assigned_names(target))

        def holds_exp(node: ast.AST) -> bool:
            return (self._contains_exp(module, node)
                    or bool(names_read(node) & exp_names))

        def holds_sumexp(node: ast.AST) -> bool:
            return (self._contains_sum_of_exp(module, node, exp_names)
                    or bool(names_read(node) & sumexp_names))

        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                canon = module.canonical(node.func) or ""
                if last_segment(canon) == "log" and node.args \
                        and holds_sumexp(node.args[0]):
                    yield self.finding(
                        module, node,
                        "hand-rolled logsumexp: log of a sum of exp "
                        "with no max subtraction in reach — overflows "
                        "to inf on realistic logits; use "
                        "torch.logsumexp (or subtract the max first, "
                        "like the blocked-xent kernel)")
            elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                if holds_sumexp(node.right) and holds_exp(node.left):
                    yield self.finding(
                        module, node,
                        "hand-rolled softmax: exp(x) divided by a sum of "
                        "exp with no max subtraction in reach — overflows "
                        "to inf on realistic logits; use torch.softmax "
                        "(or the online-softmax kernels in ops/cuda/)")



@register
class ControlSeamRule(Rule):
    """CT01 — raw ring/pool mutation in the control plane.

    The autoscaler's correctness argument (DESIGN.md §26) rests on
    every scale action being all-or-nothing THROUGH the serving seams:
    ``PrefixRouter.scale_up`` gates ring admission on the warmed flag,
    ``scale_down`` drains via the quarantine state machine and refuses
    to detach a replica with requests in flight, and the pool publishes
    whole rings atomically.  A control module that calls
    ``ring.add``/``ring.remove``, builds a ``HashRing`` itself, assigns
    ``router.ring``, or reaches into ``pool._replicas``/``pool._state``
    re-creates exactly the failure modes those seams were built to make
    unrepresentable: a cold replica on the ring (compile-storm TTFT), a
    half-drained replica, or a reader observing a mid-mutation ring.

    Fires, in modules under ``control/``, on: calls whose dotted target
    ends in ``.ring.add`` / ``.ring.remove`` / ``.ring.rebuild``; any
    ``HashRing(...)`` construction; assignment to an attribute ending
    ``.ring``; and any read/write of a ``._replicas`` / ``._state``
    attribute reached through another object (pool internals).

    Blind spots: mutation behind an alias (``r = router.ring`` then
    ``r.add(...)`` — only the aliasing assignment's reads escape), and
    helpers outside ``control/`` that mutate on control's behalf (the
    review catches those; keep actuators in serving).  Silence a
    deliberate hit with ``# graftlint: disable=CT01`` plus the reason.
    """

    id = "CT01"
    title = "control plane bypasses the ReplicaPool/PrefixRouter seams"

    _RING_CALL_SUFFIXES = (".ring.add", ".ring.remove", ".ring.rebuild")
    _INTERNAL_ATTRS = {"_replicas", "_state"}

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        path = module.path.replace("\\", "/")
        if "/control/" not in path and not path.startswith("control/"):
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                canon = module.canonical(node.func) \
                    or dotted_name(node.func) or ""
                if any(canon.endswith(s) for s in self._RING_CALL_SUFFIXES):
                    yield self.finding(
                        module, node,
                        f"`{canon}` mutates a hash ring directly from the "
                        "control plane — scale through "
                        "`PrefixRouter.scale_up`/`scale_down` (warmed "
                        "gate + quarantine drain + atomic ring swap)")
                elif last_segment(canon) == "HashRing":
                    yield self.finding(
                        module, node,
                        "control code builds a `HashRing` itself — ring "
                        "construction belongs to the router's atomic "
                        "swap; act through `PrefixRouter.scale_up`/"
                        "`scale_down` instead")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    name = dotted_name(t) or ""
                    if name.endswith(".ring") and "." in name:
                        yield self.finding(
                            module, t,
                            f"assignment to `{name}` swaps a router's "
                            "ring from the control plane — only the "
                            "router publishes rings (atomically, under "
                            "its own lock)")
            elif isinstance(node, ast.Attribute):
                if node.attr in self._INTERNAL_ATTRS \
                        and isinstance(node.value, ast.Attribute):
                    owner = dotted_name(node.value) or "<pool>"
                    yield self.finding(
                        module, node,
                        f"`{owner}.{node.attr}` reaches into pool "
                        "internals from the control plane — use the "
                        "pool's public membership seams "
                        "(`add_replica`/`drain_replica`/"
                        "`remove_replica`/`inflight`)")


#: page-accounting calls that move refcounts or hand pages across tiers —
#: inside serving/disagg/ these belong to the KVMigrator seams only
_DG_ACCOUNTING = {
    "alloc", "incref", "decref", "decref_quarantine", "lookup_prefix",
    "insert_prefix", "clear_prefix", "requeue", "queue_wipe",
    "admit_from_pages",
}


@register
class DisaggSeamRule(Rule):
    """DG01: page accounting or block-table writes in ``serving/disagg/``
    outside the ``KVMigrator`` export/import seams.

    The disagg tier's whole correctness story is one invariant: a
    migrated request's page refcounts hand off ATOMICALLY — the decode
    pool's claims plus fresh allocations transfer to the engine in the
    same step that queues the request, and every abort path releases
    exactly what it acquired (the chaos legs assert refcounts balance to
    zero leaked pages).  That invariant is auditable only because every
    pool acquire/release and block-table mutation in the package funnels
    through the :class:`~..serving.disagg.migrate.KVMigrator`'s seams —
    PG01's acquire/release discipline extended across the process
    boundary.  A scheduler (or future tier code) that increfs a page or
    pokes a block table itself reintroduces the scattered-refcount bug
    class the seam exists to kill.

    Fires, in modules whose path contains ``serving/disagg``, on (a) any
    call whose attribute is a page-accounting method (``alloc``,
    ``incref``, ``decref``, ``decref_quarantine``, ``lookup_prefix``,
    ``insert_prefix``, ``clear_prefix``, ``requeue``, ``queue_wipe``,
    ``admit_from_pages``) and (b) any assignment whose target mentions a
    block table (``bt`` / ``block_table``) — when the enclosing class is
    not ``KVMigrator``.

    Blind spots: accounting reached through a helper defined outside the
    package (the helper's own module gets PG01 instead), and a pool
    aliased into a collection.  Silence a deliberate hit with
    ``# graftlint: disable=DG01`` plus the reason.
    """

    id = "DG01"
    title = "disagg page accounting outside the KVMigrator seams"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        path = module.path.replace("\\", "/")
        if "serving/disagg" not in path:
            return
        # map every node to its enclosing class, one walk
        owner: dict[int, str] = {}

        def _mark(node: ast.AST, cls: str | None) -> None:
            if isinstance(node, ast.ClassDef):
                cls = node.name
            for child in ast.iter_child_nodes(node):
                if cls is not None:
                    owner[id(child)] = cls
                _mark(child, cls)

        _mark(module.tree, None)
        for node in ast.walk(module.tree):
            if owner.get(id(node)) == "KVMigrator":
                continue
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _DG_ACCOUNTING:
                recv = dotted_name(node.func.value) or "<expr>"
                yield self.finding(
                    module, node,
                    f"`{recv}.{node.func.attr}` moves page references "
                    "outside the KVMigrator export/import seams — route "
                    "it through the migrator so the refcount handoff "
                    "stays atomic and auditable (DESIGN.md §27)")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    name = (dotted_name(t) or "").lower()
                    seg = name.rsplit(".", 1)[-1]
                    if seg == "bt" or "block_table" in name:
                        yield self.finding(
                            module, t,
                            f"assignment to `{dotted_name(t)}` writes a "
                            "block table outside the KVMigrator seams — "
                            "block-table rows are installed only by the "
                            "engine's admit path on the migrator's "
                            "behalf (DESIGN.md §27)")
