"""Tier-1 gate: the port stays graftlint-clean under its own baseline.

The test form of ``python -m deeplearning4j_tpu_torch.analysis --check``:
any hazard in ``deeplearning4j_tpu_torch/`` that is neither suppressed
inline with a reason nor carried in ``graftlint_torch.baseline.json``
fails here.  The baseline stays honest: every entry still fires (no
stale lines), carries a real justification (no TODOs), and every inline
suppression in the port names its reason.  The whole package is linted
once for the module.
"""

import os
import re

import pytest

from deeplearning4j_tpu_torch.analysis import (SUPPRESSED, Analyzer,
                                               Baseline, active)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "graftlint_torch.baseline.json")
PACKAGE = os.path.join(REPO, "deeplearning4j_tpu_torch")


@pytest.fixture(scope="module")
def lint():
    analyzer = Analyzer(baseline=Baseline.load(BASELINE), root=REPO)
    return analyzer, analyzer.analyze_paths([PACKAGE])


def test_port_has_no_new_violations(lint):
    analyzer, findings = lint
    assert analyzer.errors == [], f"unparseable files: {analyzer.errors}"
    assert analyzer.visited_files > 150
    fresh = active(findings)
    listing = "\n".join(
        f"  {f.path}:{f.line}: {f.rule} {f.message}" for f in fresh)
    assert not fresh, (
        f"{len(fresh)} new graftlint violation(s) in the port — fix them, "
        f"suppress inline with a reason, or (last resort) baseline with a "
        f"justification:\n{listing}")


def test_baseline_has_no_stale_entries(lint):
    _, findings = lint
    stale = Baseline.load(BASELINE).stale_entries(findings)
    listing = "\n".join(f"  {e['rule']} {e['path']}: {e['code']!r}"
                        for e in stale)
    assert not stale, (
        f"baseline entries that no longer fire — delete them:\n{listing}")


def test_baseline_entries_are_justified():
    entries = Baseline.load(BASELINE).entries
    assert entries
    for e in entries:
        just = e.get("justification", "")
        assert len(just) > 40 and "TODO" not in just, (
            f"baseline entry {e['rule']} {e['path']} lacks a real "
            f"justification: {just!r}")
        assert e["path"].startswith("deeplearning4j_tpu_torch/")


def test_every_inline_suppression_names_its_reason(lint):
    """A pragma on a code line has its reason on the comment line above
    it; a comment-only pragma has it on the lines just above or after
    its rule list."""
    _, findings = lint
    suppressed = [f for f in findings if f.status == SUPPRESSED]
    assert suppressed
    for f in suppressed:
        lines = open(os.path.join(REPO, f.path)).read().splitlines()
        near = "\n".join(lines[max(0, f.line - 6):f.line])
        prose = re.sub(r"graftlint:\s*disable\S*(=[A-Z0-9_,]+)?", "", near)
        words = re.findall(r"[A-Za-z]{2,}",
                           " ".join(re.findall(r"#([^\n]*)", prose)))
        assert len(words) >= 3, (
            f"{f.path}:{f.line}: suppressed {f.rule} without a reason")
