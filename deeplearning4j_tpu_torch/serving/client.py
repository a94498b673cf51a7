"""Minimal stdlib client for :class:`~.server.ModelServer`.

Port of ``ServingClient`` from ``deeplearning4j_tpu/serving/client.py``.
Rejections surface as :class:`ServingError` carrying the HTTP status, so
callers can tell backpressure (429) from bad requests (400).  Idempotent
GETs are retried once with a short backoff on a dead connection; POSTs
are never retried (a generate whose connection died may have run).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request


class ServingError(RuntimeError):
    """An HTTP error answer from the model server."""

    def __init__(self, status: int, detail: str):
        super().__init__(f"HTTP {status}: {detail}")
        self.status = status
        self.detail = detail


class ServingClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 timeout_s: float = 60.0, retries: int = 1,
                 retry_backoff_s: float = 0.05):
        self.base = f"http://{host}:{port}"
        self.timeout_s = timeout_s
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s

    def _request(self, path: str, payload: dict | None = None,
                 timeout_s: float | None = None) -> bytes:
        data = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"} if data else {}
        req = urllib.request.Request(
            self.base + path, data=data, method="POST" if data else "GET",
            headers=headers)
        deadline = timeout_s if timeout_s is not None else self.timeout_s
        attempts = 1 + (self.retries if data is None else 0)
        for attempt in range(attempts):
            try:
                with urllib.request.urlopen(req, timeout=deadline) as r:
                    return r.read()
            except urllib.error.HTTPError as e:
                raw = e.read()
                try:
                    detail = json.loads(raw).get(
                        "error", raw.decode("utf-8", "replace"))
                except (ValueError, AttributeError):
                    detail = raw.decode("utf-8", "replace")
                raise ServingError(e.code, detail) from e
            except OSError:
                # URLError (refused / reset) or a socket timeout
                if attempt + 1 >= attempts:
                    raise
                time.sleep(self.retry_backoff_s * (2 ** attempt))
        raise AssertionError("unreachable")

    def _json(self, path: str, payload: dict | None = None,
              timeout_s: float | None = None) -> dict:
        return json.loads(self._request(path, payload, timeout_s=timeout_s))

    def generate(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: int | None = None,
                 deadline_ms: float | None = None,
                 tenant: str | None = None, priority: int = 0,
                 timeout_s: float | None = None) -> dict:
        body = {"prompt": list(prompt), "max_new_tokens": max_new_tokens,
                "temperature": temperature, "seed": seed}
        if eos_id is not None:
            body["eos_id"] = eos_id
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        if tenant:
            body["tenant"] = tenant
        if priority:
            body["priority"] = int(priority)
        return self._json("/v1/generate", body, timeout_s=timeout_s)

    def score(self, inputs) -> list:
        """Rows in, the scorer's output rows out (``/v1/score``)."""
        return self._json("/v1/score", {"inputs": [list(map(float, r))
                                                   for r in inputs]})["outputs"]

    def reload(self, step: int | None = None) -> int:
        """Hot swap the served weights (``/v1/reload``); returns the target
        step.  409 (a :class:`ServingError`) when nothing verifies."""
        body = {} if step is None else {"step": step}
        return self._json("/v1/reload", body)["step"]

    def healthz(self, timeout_s: float | None = None) -> dict:
        return self._json("/healthz", timeout_s=timeout_s)

    def metrics(self, timeout_s: float | None = None) -> dict:
        return self._json("/metrics", timeout_s=timeout_s)

    def metrics_prom(self, timeout_s: float | None = None) -> str:
        return self._request("/metrics.prom", timeout_s=timeout_s).decode()
