"""HTTP front end for the inference engine.

Port of ``ModelServer`` from ``deeplearning4j_tpu/serving/server.py``
(stdlib ``ThreadingHTTPServer``, ``port=0`` auto-assign, quiet logging):

- ``POST /v1/generate`` — body ``{"prompt": [ids], "max_new_tokens",
  "temperature", "seed", "eos_id", "deadline_ms", "tenant", "priority"}``
  → ``{"tokens", "finish_reason", "latency_s", "ttft_s", "generation",
  "loaded_step"}``
- ``POST /v1/score``    — batched forward through a ``BatchScorer``;
  ``{"inputs": [[...], ...]}`` → ``{"outputs": [[...], ...]}``
- ``POST /v1/reload``   — hot swap to ``latest_valid_step()`` (or an
  explicit ``{"step": N}``) → ``{"step": N}``
- ``GET /healthz``      — liveness + engine slot/queue stats
- ``GET /metrics``      — JSON registry snapshot
- ``GET /metrics.prom`` — Prometheus text exposition

Error contract: backpressure keeps its HTTP status (``QueueFull`` → 429,
``DeadlineExceeded`` → 504), malformed requests → 400, a route whose
engine or scorer is not mounted → 400, a reload with nothing to load →
409.  ``/v1/migrate`` comes with the disagg roles (ROADMAP.md A8).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..observability.metrics import MetricsRegistry
from .batcher import ServingRejected


class ModelServer:
    """REST endpoint over an :class:`~.engine.InferenceEngine` and/or a
    :class:`~.engine.BatchScorer` (either may be None; its route 400s).
    Serves the engine's metrics registry (else the scorer's) unless
    ``registry`` names another."""

    def __init__(self, engine=None, scorer=None,
                 registry: MetricsRegistry | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 60.0):
        self.engine = engine
        self.scorer = scorer
        if registry is None:
            registry = (engine.metrics if engine is not None
                        else scorer.metrics if scorer is not None
                        else MetricsRegistry())
        self.registry = registry
        self.request_timeout_s = request_timeout_s
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes,
                      content_type: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, payload) -> None:
                self._send(code, json.dumps(payload).encode())

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, outer._health())
                elif self.path == "/metrics":
                    self._json(200, outer.registry.snapshot())
                elif self.path == "/metrics.prom":
                    self._send(200, outer.registry.to_prometheus().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError as e:   # JSONDecodeError is a ValueError
                    return self._json(400, {"error": f"bad request body: {e}"})
                routes = {"/v1/generate": outer._generate,
                          "/v1/score": outer._score,
                          "/v1/reload": outer._reload}
                if self.path not in routes:
                    return self._json(404, {"error": f"no route {self.path}"})
                try:
                    return self._json(200, routes[self.path](payload))
                except ServingRejected as e:
                    outer.registry.increment("serving.http.rejected")
                    return self._json(e.status, {"error": str(e)})
                except TimeoutError as e:
                    return self._json(504, {"error": str(e)})
                except (TypeError, ValueError, KeyError) as e:
                    return self._json(400, {"error": str(e)})
                except (FileNotFoundError, RuntimeError) as e:
                    return self._json(409, {"error": str(e)})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def _generate(self, p: dict) -> dict:
        if self.engine is None:
            raise ValueError("no InferenceEngine mounted on this server")
        if "prompt" not in p:
            raise ValueError("missing required field 'prompt'")
        eos = p.get("eos_id")
        dl = p.get("deadline_ms")
        comp = self.engine.generate(
            p["prompt"], int(p.get("max_new_tokens", 16)),
            temperature=float(p.get("temperature", 0.0)),
            seed=int(p.get("seed", 0)),
            eos_id=int(eos) if eos is not None else None,
            deadline_ms=float(dl) if dl is not None else None,
            tenant=str(p.get("tenant") or ""),
            priority=int(p.get("priority", 0)),
            timeout=self.request_timeout_s)
        return {"tokens": comp.tokens, "finish_reason": comp.finish_reason,
                "latency_s": comp.latency_s, "ttft_s": comp.ttft_s,
                "generation": comp.generation,
                "loaded_step": comp.loaded_step}

    def _score(self, p: dict) -> dict:
        if self.scorer is None:
            raise ValueError("no BatchScorer mounted on this server")
        if "inputs" not in p:
            raise ValueError("missing required field 'inputs'")
        xs = np.asarray(p["inputs"], np.float32)
        if xs.ndim < 2:
            raise ValueError("'inputs' must be a batch of rows")
        ys = self.scorer.score_batch(xs, timeout=self.request_timeout_s)
        return {"outputs": ys.tolist()}

    def _reload(self, p: dict | None = None) -> dict:
        if self.engine is None:
            raise ValueError("no InferenceEngine mounted on this server")
        step = (p or {}).get("step")
        return {"step": self.engine.reload(
            step=int(step) if step is not None else None)}

    def _health(self) -> dict:
        out = {"ok": True}
        if self.engine is not None:
            out["engine"] = self.engine.stats()
        if self.scorer is not None:
            out["scorer"] = {"queue_depth": self.scorer._queue.depth()}
        return out

    def start(self) -> "ModelServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True,
                name="serving-http")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._server.server_close()

    def __enter__(self) -> "ModelServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
