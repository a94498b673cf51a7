"""The repository's stdlib readers, ``tools/metrics_dump.py`` and
``tools/trace_report.py``, on the port's output, run as they are.

Neither tool imports either package: they read the ``/metrics``,
``/status`` and ``/metrics.prom`` endpoints a ``StatusServer`` serves,
the ``TimeSeriesStore`` JSONL exports and the ``Tracer``'s Chrome and
JSONL exports.  Here the port's engine serves requests on the CPU, the
port's ``StatusServer``, ``TimeSeriesStore`` and ``TRACER`` publish
them, and the tools render their tables and per-request columns from
that — so the port needs no copy of either tool.
"""

import json
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch import observability as tobs
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.serving import InferenceEngine, ServingConfig
from torch_port_obs import port_obs  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"
sys.path.insert(0, str(TOOLS))

import metrics_dump  # noqa: E402
import trace_report  # noqa: E402

CPU = "cpu"
KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=32, dtype=torch.float32)
REQUESTS = [([5, 9, 13, 2, 30], 5, "acme"), ([1, 2, 3], 4, "globex"),
            ([5, 9, 13, 2, 7, 7], 3, "acme")]


def _tool(name, *args):
    out = subprocess.run([sys.executable, str(TOOLS / name), *map(str, args)],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.fixture
def served():
    """A CPU engine that served three requests; the tokens it returned."""
    model = ttr.TransformerLM(ttr.TransformerConfig(**KW), device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, params, cfg=ServingConfig(
        slots=2, paged=True, page_size=4, resolve_every=2), device=CPU)
    with engine:
        tokens = [engine.generate(p, n, tenant=t).tokens
                  for p, n, t in REQUESTS]
    return tokens


class _Tracker:
    def workers(self):
        return ["w0"]

    def is_enabled(self, w):
        return True

    def last_heartbeat(self, w):
        return 0.0

    def current_jobs(self):
        return [1]

    def updates(self):
        return {}

    def is_done(self):
        return False


def test_metrics_dump_renders_the_port_status_server(served):
    server = tobs.StatusServer(tracker=_Tracker()).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            snap = json.loads(r.read().decode())
        text = _tool("metrics_dump.py", "--port", server.port)
        prom = _tool("metrics_dump.py", "--port", server.port, "--prom")
        with urllib.request.urlopen(base + "/metrics.prom", timeout=10) as r:
            want_prom = r.read().decode()
    finally:
        server.stop()
    # the tool's tables are its own renderers over the port's snapshot
    assert text.startswith(metrics_dump.render_metrics(snap))
    c = snap["counters"]
    assert c["serving.requests"] == len(REQUESTS)
    assert c["serving.tokens"] == sum(len(t) for t in served)
    for section in ("serving", "counters", "gauges", "timers", "tenants"):
        assert f"\n{section}" in "\n" + text or text.startswith(section), \
            section
    assert "serving.tokens" in text and "status\n" in text
    assert "w0" in text                                # the /status table
    assert prom == want_prom
    assert "serving_tokens" in prom


def test_metrics_dump_timeline_reads_the_port_timeseries(tmp_path, served):
    store = tobs.TimeSeriesStore(interval_s=0.05, out_dir=tmp_path)
    for t in (1.0, 2.0, 3.0):
        tobs.METRICS.increment("serving.tokens", 2)
        assert store.sample_once(t=t) > 0
    store.stop()
    text = _tool("metrics_dump.py", "--timeline", tmp_path, "--series",
                 "serving.tokens")
    assert text == metrics_dump.render_timeline(str(tmp_path),
                                                "serving.tokens") + "\n"
    row = next(l for l in text.splitlines()
               if l.strip().startswith("serving.tokens "))
    n0 = sum(len(t) for t in served)
    assert row.split()[1:5] == ["3", f"{n0 + 2:g}", f"{n0 + 6:g}",
                                f"{n0 + 6:g}"]
    assert "timeline (" in text and "over 2.0s" in text


def test_trace_report_merges_the_port_exports(tmp_path):
    """Two exports as two processes would leave them: the first two
    requests in a Chrome trace, the third in a JSONL stream.  The merge
    holds every event once and a row per request with the engine's
    phases, tokens and tenant."""
    model = ttr.TransformerLM(ttr.TransformerConfig(**KW), device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, params, cfg=ServingConfig(
        slots=2, paged=True, page_size=4, resolve_every=2), device=CPU)
    tokens = []
    with engine:
        for i, (p, n, t) in enumerate(REQUESTS):
            if i == 2:
                chrome = tobs.TRACER.save_chrome_trace(tmp_path / "a.json")
                tobs.TRACER.clear()
            tokens.append(engine.generate(p, n, tenant=t).tokens)
    jsonl = tobs.TRACER.export_jsonl(tmp_path / "b.jsonl")
    n_events = sum(len(trace_report.load_events(f)[0])
                   for f in (chrome, jsonl))
    merged = tmp_path / "merged.json"
    text = _tool("trace_report.py", chrome, jsonl, "--out", merged,
                 "--limit", "0")
    out = json.loads(merged.read_text())
    assert len(out["traceEvents"]) == n_events
    assert out["metadata"]["sources"] == [str(chrome), str(jsonl)]
    rows = trace_report.request_breakdowns(out["traceEvents"])
    assert len(rows) == len(REQUESTS)
    assert [r["tokens"] for r in rows] == [len(t) for t in tokens]
    assert [r["tenant"] for r in rows] == [t for _, _, t in REQUESTS]
    for r in rows:
        assert r["prefill_ms"] > 0 and r["decode_segments"] >= 1
        assert 0 < r["ttft_ms"] <= r["total_ms"]
        assert r["route_ms"] is None and r["route_hops"] == 0
    assert text.splitlines()[1:] == trace_report.render(
        rows, 0).splitlines()
    lines = text.splitlines()
    header = next(l for l in lines if l.startswith("trace_id"))
    assert header.split() == ["trace_id", "tenant", "queue", "route", "hops",
                              "prefill", "decode", "segs", "emit", "ttft",
                              "slo", "total", "tokens"]
    body = lines[lines.index(header) + 2:]
    for r in rows:
        row = next(l for l in body if l.startswith(r["trace_id"][:12]))
        cells = row.split()
        assert cells[1] == r["tenant"] and cells[-1] == str(r["tokens"])
        assert cells[3] == "-" and cells[4] == "-"     # no router hop
    assert any("TTFT p50=" in l for l in lines)
    assert any(l.startswith("SLO serving_ttft") for l in lines)
