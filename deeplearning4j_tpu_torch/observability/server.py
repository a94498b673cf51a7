"""HTTP status/metrics endpoint.

Port of ``deeplearning4j_tpu/observability/server.py``: a read-only
``ThreadingHTTPServer`` serving

- ``/healthz``       — liveness, ``{"ok": true}``
- ``/metrics``       — JSON registry snapshot
- ``/metrics.prom``  — Prometheus text exposition
- ``/status``        — a tracker's state (workers, heartbeats, jobs), each
  field read on its own: a failing read lands in an ``errors`` list,
  never a 500.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from .metrics import METRICS, MetricsRegistry


class StatusServer:
    """REST endpoint over a metrics registry + optional StateTracker."""

    def __init__(self, tracker=None, registry: MetricsRegistry = METRICS,
                 host: str = "127.0.0.1", port: int = 0):
        self.tracker = tracker
        self.registry = registry
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, content_type: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    payload = {"ok": True}
                elif self.path == "/metrics":
                    payload = outer.registry.snapshot()
                elif self.path == "/metrics.prom":
                    self._send(outer.registry.to_prometheus().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                    return
                elif self.path == "/status":
                    payload = outer._tracker_state()
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self._send(json.dumps(payload).encode(), "application/json")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def _tracker_state(self) -> dict:
        """Tracker snapshot tolerant of concurrent worker eviction: each
        field is gathered independently and per-worker lookups that raise
        (worker gone between ``workers()`` and the lookup) are skipped —
        the endpoint returns whatever it could read plus an ``errors``
        list, never a 500."""
        t = self.tracker
        if t is None:
            return {}
        state: dict[str, Any] = {}
        errors: list[str] = []

        def _get(key, fn):
            try:
                state[key] = fn()
            except Exception as e:  # partial status beats a 500
                errors.append(f"{key}: {type(e).__name__}: {e}")

        _get("workers", t.workers)
        workers = state.get("workers", [])

        def _per_worker(fn):
            out = {}
            for w in workers:
                try:
                    out[w] = fn(w)
                except Exception as e:
                    errors.append(f"{w}: {type(e).__name__}: {e}")
            return out

        _get("enabled", lambda: _per_worker(t.is_enabled))
        _get("heartbeats_age_s",
             lambda: _per_worker(lambda w: round(time.time() - t.last_heartbeat(w), 3)))
        _get("current_jobs", lambda: len(t.current_jobs()))
        _get("pending_updates", lambda: sorted(t.updates().keys()))
        # in-memory tracker exposes its counter dict; the file-backed
        # tracker has no cheap enumerate — omit rather than scan disk
        _get("counters", lambda: dict(getattr(t, "_counters", {})))
        _get("done", t.is_done)
        if errors:
            state["errors"] = errors
        return state

    def start(self) -> "StatusServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
