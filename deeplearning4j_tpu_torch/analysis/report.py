"""graftlint reporting: human text, machine JSON, and metrics gauges.

Port of ``deeplearning4j_tpu/analysis/report.py`` (a copy).  The
metrics side closes the loop with the observability layer: every
analyzer run publishes one ``graftlint.violations.<RULE>`` gauge per rule
(count of ACTIVE findings — suppressed/baselined ones are counted
separately in the JSON report) plus a ``graftlint.runs`` counter, so a CI
scrape of ``/metrics.prom`` can alert on lint regressions the same way it
alerts on step-time regressions.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable

from .core import ACTIVE, BASELINED, SUPPRESSED, Finding, all_rules


def summarize(findings: Iterable[Finding]) -> dict:
    findings = list(findings)
    by_status = Counter(f.status for f in findings)
    by_rule: dict[str, dict[str, int]] = {}
    for rule_id in sorted(all_rules()):
        per = Counter(f.status for f in findings if f.rule == rule_id)
        by_rule[rule_id] = {"active": per.get(ACTIVE, 0),
                            "suppressed": per.get(SUPPRESSED, 0),
                            "baselined": per.get(BASELINED, 0)}
    return {
        "total": len(findings),
        "active": by_status.get(ACTIVE, 0),
        "suppressed": by_status.get(SUPPRESSED, 0),
        "baselined": by_status.get(BASELINED, 0),
        "by_rule": by_rule,
    }


def to_json(findings: Iterable[Finding], errors: list[str] | None = None) -> dict:
    """Machine-readable report (the ``--json`` CLI payload, shaped for CI
    annotation: one record per finding with file/line/rule/message)."""
    findings = list(findings)
    return {
        "tool": "graftlint",
        "summary": summarize(findings),
        "findings": [{
            "rule": f.rule, "path": f.path, "line": f.line, "col": f.col,
            "status": f.status, "message": f.message, "code": f.code,
        } for f in findings],
        **({"errors": errors} if errors else {}),
    }


def to_text(findings: Iterable[Finding], show_all: bool = False) -> str:
    """Compiler-style lines for active findings (all statuses with
    ``show_all``)."""
    out = []
    for f in findings:
        if f.status != ACTIVE and not show_all:
            continue
        tag = "" if f.status == ACTIVE else f" [{f.status}]"
        out.append(f"{f.path}:{f.line}:{f.col}: {f.rule}{tag} {f.message}")
    return "\n".join(out)


def emit_metrics(findings: Iterable[Finding], registry=None,
                 skipped: int = 0) -> None:
    """Publish per-rule gauges through the observability layer.  Imported
    lazily so the analyzer stays usable without torch/observability on the
    path (e.g. a bare CI box running only the linter).  ``skipped`` is the
    analyzer's unreadable/unparseable file count — published as the
    ``graftlint.skipped_files`` gauge so hostile inputs degrade visibly
    instead of silently shrinking coverage."""
    if registry is None:
        try:
            from ..observability import METRICS as registry
        except Exception:
            return
    findings = list(findings)
    registry.increment("graftlint.runs")
    for rule_id in sorted(all_rules()):
        n = sum(1 for f in findings
                if f.rule == rule_id and f.status == ACTIVE)
        registry.gauge(f"graftlint.violations.{rule_id}", n)
    registry.gauge("graftlint.violations.total",
                   sum(1 for f in findings if f.status == ACTIVE))
    registry.gauge("graftlint.skipped_files", skipped)
