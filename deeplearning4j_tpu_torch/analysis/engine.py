"""graftlint engine: walk files, run rules, apply suppressions + baseline.

Port of ``deeplearning4j_tpu/analysis/engine.py`` (a copy, same pragma
syntax).

Suppression syntax (flake8-noqa flavored, but per-rule):

- ``code()  # graftlint: disable=HS01`` — silence HS01 on this line
- ``# graftlint: disable=HS01,RC01`` on a comment-only line — silence on
  the next non-comment line
- ``# graftlint: disable-file=HOT02`` anywhere — silence for the file
- ``disable`` with no ``=RULES`` silences every rule at that scope

A suppressed finding is kept (status ``suppressed``) so ``--json`` output
and the metrics gauges can count them; it never fails ``--check``.
"""

from __future__ import annotations

import os
import re
from typing import Iterable

from .baseline import Baseline
from .core import ACTIVE, BASELINED, SUPPRESSED, Finding, all_rules
from .jitinfo import ModuleInfo

_PRAGMA = re.compile(
    r"#\s*graftlint:\s*(disable(?:-file)?)\s*(?:=\s*([A-Z0-9_,\s]+))?")

#: sentinel rule-set meaning "every rule"
_ALL = frozenset({"*"})


def _parse_pragmas(source: str) -> tuple[dict[int, frozenset[str]],
                                         frozenset[str]]:
    """(line -> suppressed rule ids, file-wide suppressed rule ids)."""
    per_line: dict[int, frozenset[str]] = {}
    file_wide: set[str] = set()
    lines = source.splitlines()
    for i, line in enumerate(lines, start=1):
        m = _PRAGMA.search(line)
        if not m:
            continue
        kind = m.group(1)
        rules = (frozenset(r.strip() for r in m.group(2).split(",") if r.strip())
                 if m.group(2) else _ALL)
        if kind == "disable-file":
            file_wide |= set(rules)
            continue
        stripped = line.strip()
        if stripped.startswith("#"):
            # comment-only pragma: applies to the next non-comment line
            target = i + 1
            while target <= len(lines) and (
                    not lines[target - 1].strip()
                    or lines[target - 1].strip().startswith("#")):
                target += 1
            per_line[target] = per_line.get(target, frozenset()) | rules
        else:
            per_line[i] = per_line.get(i, frozenset()) | rules
    return per_line, frozenset(file_wide)


def _suppressed(rules: frozenset[str], rule_id: str) -> bool:
    return "*" in rules or rule_id in rules


class Analyzer:
    """Run the rule set over sources, then classify each finding as
    active / suppressed / baselined."""

    def __init__(self, rules=None, baseline: Baseline | None = None,
                 root: str | None = None):
        self.rules = rules if rules is not None else list(all_rules().values())
        self.baseline = baseline or Baseline()
        self.root = root  # paths in findings are made relative to this
        self.errors: list[str] = []   # unparseable files (reported, not fatal)
        self.visited_files = 0        # files actually analyzed (--diff proof)
        self.skipped_files = 0        # unreadable/unparseable files skipped

    # ------------------------------------------------------------------ files
    def _relpath(self, path: str) -> str:
        p = os.path.relpath(path, self.root) if self.root else path
        return p.replace("\\", "/")

    def iter_py_files(self, paths: Iterable[str]):
        for path in paths:
            if os.path.isfile(path):
                yield path
            elif os.path.isdir(path):
                for dirpath, dirnames, filenames in os.walk(path):
                    dirnames[:] = sorted(
                        d for d in dirnames
                        if d not in ("__pycache__", ".git", ".cache"))
                    for f in sorted(filenames):
                        if f.endswith(".py"):
                            yield os.path.join(dirpath, f)

    # ------------------------------------------------------------------ run
    def analyze_source(self, source: str, path: str) -> list[Finding]:
        self.visited_files += 1
        try:
            module = ModuleInfo(self._relpath(path), source)
        except (SyntaxError, ValueError) as e:
            # hostile input (syntax error, NUL byte): skip the file with a
            # counted, reported error instead of aborting the whole run
            self.errors.append(f"{path}: {e}")
            self.skipped_files += 1
            return []
        findings: list[Finding] = []
        for rule in self.rules:
            try:
                findings.extend(rule.check(module))
            except Exception as e:  # one brittle rule must not kill the run
                self.errors.append(
                    f"{path}: rule {rule.id} crashed: {e!r}")
        per_line, file_wide = _parse_pragmas(source)
        for f in findings:
            if _suppressed(file_wide, f.rule) or _suppressed(
                    per_line.get(f.line, frozenset()), f.rule):
                f.status = SUPPRESSED
            elif self.baseline.contains(f):
                f.status = BASELINED
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return findings

    def analyze_paths(self, paths: Iterable[str]) -> list[Finding]:
        findings: list[Finding] = []
        for path in self.iter_py_files(paths):
            try:
                with open(path, encoding="utf-8") as fh:
                    source = fh.read()
            except (OSError, UnicodeDecodeError) as e:
                self.errors.append(f"{path}: {e}")
                self.skipped_files += 1
                continue
            findings.extend(self.analyze_source(source, path))
        return findings


def active(findings: Iterable[Finding]) -> list[Finding]:
    return [f for f in findings if f.status == ACTIVE]
