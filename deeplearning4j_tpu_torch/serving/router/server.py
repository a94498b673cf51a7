"""HTTP front end for the router tier — the same surface as
:class:`~..server.ModelServer`, so clients cannot tell one replica from N.

Port of ``deeplearning4j_tpu/serving/router/server.py``:

- ``POST /v1/generate``  — routed decode; the answer also carries
  ``replica`` and ``spills``
- ``POST /v1/reload``    — hot swap on every active replica
- ``GET  /healthz``      — router liveness + per-replica breaker state
- ``GET  /metrics``      — JSON registry snapshot
- ``GET  /metrics.prom`` — Prometheus text exposition

Error contract: 429 only when every tried replica shed, 503 when the ring
has no live node or a transient fault is injected, 504 for deadline
misses, 400 for malformed requests.  An inbound W3C ``traceparent`` binds
the handler thread's trace context, so the router's spans (and, through
the client hop, the replica's) join the caller's trace.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ...observability import METRICS, MetricsRegistry, trace
from ...resilience.faults import InjectedFault
from ..batcher import ServingRejected
from ..client import ServingError
from .router import PrefixRouter


class RouterServer:
    """REST endpoint over a :class:`PrefixRouter`."""

    def __init__(self, router: PrefixRouter,
                 registry: MetricsRegistry = METRICS,
                 host: str = "127.0.0.1", port: int = 0):
        self.router = router
        self.registry = registry
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
                except (ValueError, json.JSONDecodeError) as e:
                    return self._json(400, {"error": f"bad request body: {e}"})
                ctx = trace.parse_traceparent(self.headers.get("traceparent"))
                try:
                    with trace.bind(*ctx) if ctx else trace.bind(None):
                        if self.path == "/v1/generate":
                            return self._json(200, outer._generate(payload))
                        if self.path == "/v1/reload":
                            return self._json(200, outer._reload(payload))
                    return self._json(404, {"error": f"no route {self.path}"})
                except ServingRejected as e:
                    # 429 spill-exhausted / 503 no live replica / 504
                    METRICS.increment("router.http.rejected")
                    return self._json(e.status, {"error": str(e)})
                except ServingError as e:
                    # a replica's own HTTP answer, passed through verbatim
                    return self._json(e.status, {"error": e.detail})
                except InjectedFault as e:
                    return self._json(503, {"error": f"transient fault: {e}"})
                except TimeoutError as e:
                    return self._json(504, {"error": str(e)})
                except (TypeError, ValueError, KeyError) as e:
                    return self._json(400, {"error": str(e)})
                except (FileNotFoundError, RuntimeError) as e:
                    return self._json(409, {"error": str(e)})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ handlers
    def _generate(self, p: dict) -> dict:
        if "prompt" not in p:
            raise ValueError("missing required field 'prompt'")
        eos = p.get("eos_id")
        dl = p.get("deadline_ms")
        return self.router.generate(
            p["prompt"], int(p.get("max_new_tokens", 16)),
            temperature=float(p.get("temperature", 0.0)),
            seed=int(p.get("seed", 0)),
            eos_id=int(eos) if eos is not None else None,
            deadline_ms=float(dl) if dl is not None else None,
            tenant=str(p.get("tenant") or ""))

    def _reload(self, p: dict | None = None) -> dict:
        step = (p or {}).get("step")
        return {"steps": self.router.reload(
            step=int(step) if step is not None else None)}

    def _health(self) -> dict:
        replicas = self.router.stats()
        return {"ok": any(v["active"] for v in replicas.values()),
                "replicas": replicas}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "RouterServer":
        self.router.start()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True,
                name="router-http")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._server.server_close()
        self.router.close()

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
