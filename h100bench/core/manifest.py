"""``BENCHMARK.json`` and the files it names, found by name.

A cell (one ``workloads`` entry) names a configuration and a traffic mix;
each is a JSON file of its own:

- ``h100bench/configs/<config>.json``: the model as run (``model``) and
  the port's settings for each path (``train``, ``serve``);
- ``h100bench/traffic/<traffic>.json``: the mix, read by the generator its
  ``kind`` names (``train`` or ``serve``);
- ``h100bench/limits/<workload>.json``: the limits of the comparison that
  decides ``correct``, each with the readings it was set from;
- ``h100bench/metrics/<name>.py``: one per-layer metric's reader.

Nothing here is specific to a cell: a new cell is new files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]        # h100bench/
ROOT = HERE.parent                                 # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                 # the workloads entry
    config: dict                # configs/<config>.json
    traffic: dict               # traffic/<traffic>.json
    limits: dict                # limits/<workload>.json ({} before set)
    end_to_end: list            # the manifest's end_to_end entries it reports
    per_layer: list             # the manifest's per_layer entries it reports

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def settings(self) -> dict:
        """The configuration's settings for this cell's path."""
        return dict(self.config.get(self.kind, {}))


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_candidates(root: Path = ROOT) -> dict:
    """``h100bench/candidates.json``: cells that run and were proven
    correct on the card but are not in ``BENCHMARK.json`` (PERF.md's Open
    questions say why), with the metric entries they report.  Only
    ``run.py --candidates`` and the CPU rehearsal read it; the benchmark's
    own runs never do."""
    return json.loads((root / "h100bench" / "candidates.json").read_text())


def lookup(root: Path = ROOT, candidates: bool = False) -> dict:
    """The manifest; with ``candidates``, the candidate cells and their
    metrics added."""
    man = load_manifest(root)
    if candidates:
        extra = load_candidates(root)
        for key in ("workloads", "end_to_end", "per_layer"):
            man[key] = man[key] + extra[key]
    return man


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(workload: str, root: Path = ROOT,
              candidates: bool = False) -> Cell:
    man = lookup(root, candidates)
    by_name = {w["name"]: w for w in man["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"h100bench: no workload {workload!r} in "
                         f"BENCHMARK.json (have {sorted(by_name)})")
    entry = by_name[workload]
    configs = {c["name"]: c for c in man["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = _json(limits_path) if limits_path.exists() else {}
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    per_layer = [m for m in man["per_layer"] if workload in m["workloads"]]
    return Cell(workload, entry, config, traffic, limits, e2e, per_layer)


def load_metric(name: str):
    """The reader module of per-layer metric ``name``
    (``h100bench/metrics/<name>.py``; names may hold dots, so the file is
    loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
