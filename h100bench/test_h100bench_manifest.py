"""``BENCHMARK.json`` and the files it names: the schema, the characters
of every name and unit, and that each piece is a file the runner finds
by name."""

import json
import re
import statistics
from pathlib import Path

import pytest

from h100bench.core import manifest

ROOT = Path(__file__).resolve().parent.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
#: keys that name a width (the contract's list); no configuration may
#: cut them
WIDTH = re.compile(r"(^hidden_size$|^intermediate_size$|latent|state_size|"
                   r"proj.*size|head_dim|^n_embd$|^n_inner$|_dim$|_rank$|"
                   r"expansion|experts_per_tok)")


def text_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(MAN["command"]) <= 32
    for w in MAN["command"]:
        assert text_ok(w) and not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"])


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}),
])
def test_entries_have_just_their_keys(section, keys):
    entries = MAN[section]
    assert entries
    for e in entries:
        extra = set(e) - keys
        assert set(e) >= keys, (e, keys - set(e))
        assert extra <= ({"workloads"} if section == "end_to_end"
                         else set()), (e["name"], extra)
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_names_and_units_use_their_characters():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[section]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert text_ok(e[key]), (e["name"], key)
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metrics_sources_bounds_and_reporting():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in SOURCES
        assert m["moves"] in e2e
    cells = {w["name"] for w in MAN["workloads"]}
    for w in cells:
        cell = manifest.load_cell(w, ROOT)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, w
        assert cell.per_layer, w
        for m in cell.per_layer:
            # a metric's cells report the end-to-end metric it moves
            assert m["moves"] in reported, (w, m["name"])
    for m in MAN["per_layer"] + MAN["end_to_end"]:
        assert set(m.get("workloads", [])) <= cells


def test_layer_names_agree_with_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in MAN["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]


def test_four_chip_share_and_check_time():
    cells = MAN["workloads"]
    four = [w for w in cells if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in cells)
    assert len(four) <= max(1, len(cells) // 4)
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


CANDIDATES = manifest.load_candidates(ROOT)


@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]
                               + CANDIDATES["workloads"]])
def test_each_piece_is_a_file_found_by_name(w):
    cell = manifest.load_cell(w, ROOT, candidates=True)
    entry = {c["name"]: c for c in MAN["configs"]}[cell.entry["config"]]
    assert entry["file"].startswith("h100bench/configs/")
    assert (ROOT / "h100bench" / "traffic"
            / f"{cell.entry['traffic']}.json").exists()
    assert cell.kind in ("train", "serve")
    for m in cell.per_layer:
        mod = manifest.load_metric(m["name"])
        assert callable(mod.read)
    # every compared number has a limit set between its two readings
    numbers = cell.limits["numbers"]
    assert numbers
    for name, n in numbers.items():
        assert n["lower"] < n["limit"] < n["upper"], (w, name)


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_configuration_files(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert c["source"] == cfg["source"]
    assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    assert set(cfg["changed_from"]) == set(cfg["reduced"])
    for k in c["reduced"]:
        assert k in cfg and not WIDTH.search(k), k
    files = [x["file"] for x in MAN["configs"]]
    assert files.count(c["file"]) == 1


def test_every_benchmark_file_name_uses_name_characters():
    for p in (ROOT / "h100bench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


def test_spread_helper_matches_statistics_quartiles():
    from h100bench.tools import spread

    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 20.0]
    q = statistics.quantiles(vals, n=4)
    assert spread.iqr_share(vals) == pytest.approx(
        (q[2] - q[0]) / statistics.median(vals))


def test_candidates_are_outside_the_manifest():
    """A candidate is found only when asked for; its metrics name their
    cells, as the manifest's do."""
    with pytest.raises(SystemExit):
        manifest.load_cell(CANDIDATES["workloads"][0]["name"], ROOT)
    names = {w["name"] for w in MAN["workloads"]}
    metrics = {m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]}
    for w in CANDIDATES["workloads"]:
        assert w["name"] not in names
    for m in CANDIDATES["end_to_end"] + CANDIDATES["per_layer"]:
        assert m["name"] not in metrics and NAME.match(m["name"])
        assert m["workloads"], m["name"]
        assert set(m["workloads"]) <= {w["name"]
                                       for w in CANDIDATES["workloads"]}
