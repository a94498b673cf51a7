"""graftlint core: findings, rule registry, and shared AST utilities.

Port of ``deeplearning4j_tpu/analysis/core.py`` (a copy).  The analyzer
is deliberately a *hazard* linter, not a type checker: every rule encodes
one way this codebase has already been burned by its execution model
(host syncs on the asynchronous CUDA stream, seed reuse, threads, pages).
Rules are heuristic by design — they trade soundness for catching the
real patterns in this tree, and every rule can be silenced per-line
(``# graftlint: disable=HS01``) or per-file
(``# graftlint: disable-file=HS01``) when a hit is deliberate.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Iterator

#: statuses a finding can end up in after suppression/baseline filtering
ACTIVE = "active"
SUPPRESSED = "suppressed"
BASELINED = "baselined"


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    code: str = ""            # stripped source line (baseline matching key)
    status: str = ACTIVE

    def key(self) -> tuple[str, str, str]:
        """Line-number-free identity used for baseline matching: the rule,
        the file, and the stripped source text.  Survives unrelated edits
        that shift line numbers; a real change to the flagged line
        invalidates the baseline entry (which is the point)."""
        return (self.rule, self.path.replace("\\", "/"), self.code)

    def location(self) -> str:
        return f"{self.path}:{self.line}"


class Rule:
    """Base class: subclasses set ``id``/``title`` and implement ``check``."""

    id: str = ""
    title: str = ""

    def check(self, module) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, module, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        code = module.line(line)
        return Finding(rule=self.id, path=module.path, line=line,
                       col=getattr(node, "col_offset", 0) + 1,
                       message=message, code=code)


_REGISTRY: dict[str, Rule] = {}


def register(rule_cls: type[Rule]) -> type[Rule]:
    """Class decorator adding a rule to the default rule set."""
    _REGISTRY[rule_cls.id] = rule_cls()
    return rule_cls


def all_rules() -> dict[str, Rule]:
    # import for side effect: rule registration happens at module import
    from . import rules as _rules  # noqa: F401
    return dict(_REGISTRY)


# --------------------------------------------------------------------------- AST helpers

def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def last_segment(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def literal_int_tuple(node: ast.AST | None) -> tuple[int, ...] | None:
    """Evaluate a literal int / tuple-of-ints AST node (donate_argnums,
    static_argnums values); None when it is not a safe literal."""
    if node is None:
        return None
    try:
        val = ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None
    if isinstance(val, int):
        return (val,)
    if isinstance(val, (tuple, list)) and all(isinstance(v, int) for v in val):
        return tuple(val)
    return None


def iter_functions(tree: ast.Module) -> Iterator[ast.FunctionDef]:
    """Every (async) function/method definition in the module."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def assigned_names(target: ast.AST) -> Iterator[str]:
    """Dotted names bound by an assignment target (handles tuple/star
    unpacking; subscripts yield nothing)."""
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from assigned_names(elt)
    elif isinstance(target, ast.Starred):
        yield from assigned_names(target.value)
    else:
        name = dotted_name(target)
        if name is not None:
            yield name


def statement_targets(stmt: ast.stmt) -> set[str]:
    """All dotted names a statement (re)binds."""
    out: set[str] = set()
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            out.update(assigned_names(t))
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        out.update(assigned_names(stmt.target))
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        out.update(assigned_names(stmt.target))
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            if item.optional_vars is not None:
                out.update(assigned_names(item.optional_vars))
    return out


def names_read(node: ast.AST) -> set[str]:
    """Dotted names loaded anywhere under ``node`` (longest chains only:
    reading ``self.syn0`` reports ``self.syn0``, not also ``self``)."""
    out: set[str] = set()

    def visit(n: ast.AST) -> None:
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
            name = dotted_name(n)
            if name is not None:
                out.add(name)
                return  # don't descend: keep the longest chain
        elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            out.add(n.id)
            return
        for child in ast.iter_child_nodes(n):
            visit(child)

    visit(node)
    return out


def body_statements(body: Iterable[ast.stmt],
                    into_defs: bool = False) -> Iterator[ast.stmt]:
    """Statements in source order, descending into compound statements
    (but not into nested function/class definitions unless asked)."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if into_defs:
                yield from body_statements(stmt.body, into_defs)
            continue
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                yield from body_statements(sub, into_defs)
        for handler in getattr(stmt, "handlers", []) or []:
            yield from body_statements(handler.body, into_defs)
