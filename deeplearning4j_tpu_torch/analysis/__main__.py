"""graftlint CLI for the PyTorch/CUDA port — the counterpart of
``tools/graftlint.py``, linting ``deeplearning4j_tpu_torch``.

Usage (from the repo root):

    python -m deeplearning4j_tpu_torch.analysis --check [PATHS...]  # gate
    python -m deeplearning4j_tpu_torch.analysis [PATHS...]    # everything
    python -m deeplearning4j_tpu_torch.analysis --json        # machine
    python -m deeplearning4j_tpu_torch.analysis --diff HEAD   # changed
    python -m deeplearning4j_tpu_torch.analysis --write-baseline
    python -m deeplearning4j_tpu_torch.analysis --rules       # list rules

Defaults: PATHS = ``deeplearning4j_tpu_torch``, baseline =
``graftlint_torch.baseline.json`` at the repo root (``tools/graftlint.py``
and ``graftlint.baseline.json`` stay the JAX package's).  ``--check``
exits 1 when any finding is neither suppressed inline
(``# graftlint: disable=RULE``) nor carried in the baseline; it also
exits 1 on unparseable files.  ``--stale`` lists baseline entries whose
finding no longer fires.  ``--diff REF`` narrows the run to ``.py`` files
changed since REF (per ``git diff``); when git is unavailable or REF is
unknown it falls back to the full tree so the gate never weakens.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import (Analyzer, Baseline, active, all_rules, emit_metrics,
               summarize, to_json, to_text)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PACKAGE = "deeplearning4j_tpu_torch"

DEFAULT_BASELINE = os.path.join(_REPO_ROOT, "graftlint_torch.baseline.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis",
        description="AST-based hazard analyzer for the PyTorch/CUDA port "
                    "(HS01 host syncs, RNG01 seed reuse, TB01 branches on "
                    "device tensors, HOT02 uninstrumented hot loops, PL01 "
                    "kernels without a plain version, LK01-LK03/TH01 "
                    "concurrency, SH01-SH02/NM01 sharding + numerics; bare "
                    "--rules prints the full table)")
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to analyze (default: %s)" % _PACKAGE)
    p.add_argument("--check", action="store_true",
                   help="exit 1 on any non-suppressed, non-baselined finding")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit one machine-readable JSON report on stdout")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help="baseline file (default: %(default)s)")
    p.add_argument("--write-baseline", action="store_true",
                   help="write all current active findings to the baseline "
                        "(with TODO justifications) and exit 0")
    p.add_argument("--stale", action="store_true",
                   help="also report baseline entries that no longer fire")
    p.add_argument("--all", action="store_true", dest="show_all",
                   help="text mode: show suppressed/baselined findings too")
    p.add_argument("--no-metrics", action="store_true",
                   help="skip publishing graftlint.violations.* gauges")
    p.add_argument("--rules", nargs="?", const="", default=None,
                   help="comma-separated rule ids to run (default: all); "
                        "bare --rules lists every registered rule and exits")
    p.add_argument("--diff", metavar="REF", default=None,
                   help="only lint .py files changed vs the given git ref "
                        "(falls back to the full tree if git fails)")
    return p


def _changed_files(ref: str, paths: list[str]) -> list[str] | None:
    """``.py`` files changed since ``ref`` (per git, including uncommitted
    edits), restricted to the requested ``paths``.  Returns ``None`` when
    git is unavailable or the ref does not resolve — caller falls back to
    the full-tree walk so ``--diff`` can only narrow, never miss."""
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", "-z", ref, "--"],
            cwd=_REPO_ROOT, capture_output=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    changed = [os.path.join(_REPO_ROOT, p)
               for p in out.stdout.decode("utf-8", "replace").split("\0")
               if p.endswith(".py")]
    roots = [os.path.abspath(p) for p in paths]
    kept = []
    for f in changed:
        af = os.path.abspath(f)
        if any(af == r or af.startswith(r + os.sep) for r in roots):
            kept.append(f)
    return [f for f in kept if os.path.isfile(f)]


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    paths = args.paths or [os.path.join(_REPO_ROOT, _PACKAGE)]

    if args.diff is not None:
        changed = _changed_files(args.diff, paths)
        if changed is None:
            print(f"graftlint: --diff {args.diff}: git unavailable or ref "
                  f"unknown; falling back to full tree", file=sys.stderr)
        elif not changed:
            print(f"graftlint: no .py files changed vs {args.diff}")
            return 0
        else:
            paths = changed

    if args.rules == "":          # bare --rules: print the registry
        for rid, rule in sorted(all_rules().items()):
            print(f"{rid}  {rule.title}")
        return 0

    rules = None
    if args.rules:
        wanted = {r.strip().upper() for r in args.rules.split(",")}
        registry = all_rules()
        unknown = wanted - set(registry)
        if unknown:
            print(f"graftlint: unknown rule(s): {', '.join(sorted(unknown))}; "
                  f"known: {', '.join(sorted(registry))}", file=sys.stderr)
            return 2
        rules = [registry[r] for r in sorted(wanted)]

    baseline = Baseline.load(args.baseline)
    analyzer = Analyzer(rules=rules, baseline=baseline, root=_REPO_ROOT)
    findings = analyzer.analyze_paths(paths)

    if args.write_baseline:
        Baseline.from_findings(active(findings)).save(args.baseline)
        print(f"graftlint: wrote {len(active(findings))} entries to "
              f"{args.baseline}")
        return 0

    if not args.no_metrics:
        try:
            emit_metrics(findings, skipped=analyzer.skipped_files)
        except Exception:
            pass  # metrics are best-effort; the lint verdict is the product

    new = active(findings)
    if args.as_json:
        payload = to_json(findings, errors=analyzer.errors)
        payload["visited_files"] = analyzer.visited_files
        payload["skipped_files"] = analyzer.skipped_files
        if args.stale:
            payload["stale_baseline_entries"] = baseline.stale_entries(findings)
        print(json.dumps(payload, indent=2))
    else:
        text = to_text(findings, show_all=args.show_all)
        if text:
            print(text)
        for err in analyzer.errors:
            print(f"graftlint: parse error: {err}", file=sys.stderr)
        if args.stale:
            for e in baseline.stale_entries(findings):
                print(f"graftlint: stale baseline entry "
                      f"{e['rule']} {e['path']}: {e['code']!r}")
        s = summarize(findings)
        print(f"graftlint: {s['total']} finding(s) — {s['active']} active, "
              f"{s['suppressed']} suppressed, {s['baselined']} baselined")

    if args.check and (new or analyzer.errors):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
