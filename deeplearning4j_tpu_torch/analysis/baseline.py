"""graftlint baseline: a committed ledger of accepted findings.

Port of ``deeplearning4j_tpu/analysis/baseline.py`` (a copy, same file
format).

The baseline lets ``--check`` gate on NEW violations only: every entry is
a (rule, path, source-line-text) triple plus a human justification.  Line
numbers are deliberately not part of the match key — unrelated edits that
shift a file must not invalidate the ledger, while any edit to the
flagged line itself does (forcing a fresh look, which is the point of a
baseline over blanket suppression).
"""

from __future__ import annotations

import json
from typing import Iterable

from .core import Finding

VERSION = 1


class Baseline:
    """In-memory set of accepted findings, JSON-round-trippable."""

    def __init__(self, entries: list[dict] | None = None):
        self.entries = entries or []
        self._keys = {(e["rule"], e["path"], e["code"]) for e in self.entries}

    # ------------------------------------------------------------------ io
    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path, encoding="utf-8") as fh:
                data = json.load(fh)
        except FileNotFoundError:
            return cls()
        if not isinstance(data, dict) or "entries" not in data:
            raise ValueError(f"{path}: not a graftlint baseline file")
        return cls(list(data["entries"]))

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"version": VERSION, "entries": self.entries},
                      fh, indent=2, sort_keys=True)
            fh.write("\n")

    # ------------------------------------------------------------------ api
    def contains(self, finding: Finding) -> bool:
        return finding.key() in self._keys

    def stale_entries(self, findings: Iterable[Finding]) -> list[dict]:
        """Entries whose finding no longer occurs — candidates for removal
        (the hazard was fixed, or the line changed)."""
        seen = {f.key() for f in findings}
        return [e for e in self.entries
                if (e["rule"], e["path"], e["code"]) not in seen]

    @classmethod
    def from_findings(cls, findings: Iterable[Finding],
                      justification: str = "TODO: justify or fix") -> "Baseline":
        entries = [{"rule": f.rule, "path": f.path.replace("\\", "/"),
                    "line": f.line, "code": f.code,
                    "justification": justification}
                   for f in findings]
        # dedupe identical keys (same code line flagged twice)
        seen, unique = set(), []
        for e in entries:
            k = (e["rule"], e["path"], e["code"])
            if k not in seen:
                seen.add(k)
                unique.append(e)
        return cls(unique)
