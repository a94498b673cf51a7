"""Durable capture of served traffic.

Port of ``deeplearning4j_tpu/online/capture.py``, with its on-disk format,
so that either package replays the other's segments.  Append-only,
fsync'd, segment-rotated JSONL: every record is framed as ``{"sha":
sha256(rec)[:16], "rec": {...}}`` on its own line, so replay verifies
each record on its own and a damaged byte range costs the records it
covers, never the store.  Records are only ever appended to the active
segment and fsync'd before ``append`` returns, so a crash tears at most
the final line; replay skips records whose checksum no longer matches
(counted in ``capture.corrupt_records``), and a store reopened on a torn
tail seals that segment and appends to a fresh one.

Chaos sites: ``capture.write`` damages the active segment after a
durable append; ``capture.replay`` raises
:class:`~..resilience.faults.CaptureReplayFault` at replay start (a
retryable round failure).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from pathlib import Path
from typing import Iterator

from ..observability import METRICS
from ..resilience.faults import FAULTS, corrupt_file

_SEGMENT_FMT = "capture-%06d.jsonl"


def _frame(rec: dict) -> str:
    """One self-verifying JSONL line: canonical-JSON body + short sha."""
    body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    sha = hashlib.sha256(body.encode()).hexdigest()[:16]
    return json.dumps({"sha": sha, "rec": json.loads(body)},
                      sort_keys=True, separators=(",", ":"))


class CaptureStore:
    """Append-only segment-rotated JSONL store of served requests.

    ``append`` is thread-safe (HTTP handler threads feed it) and durable
    on return: write → flush → ``os.fsync``.  ``replay`` yields every
    verifiable record across all segments in append order; readers and
    the writer never coordinate — replay opens its own handles and the
    writer only ever appends.
    """

    def __init__(self, directory: str | Path, segment_bytes: int = 1 << 20):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self._lock = threading.Lock()
        existing = self.segments()
        self._seg_index = (int(existing[-1].stem.split("-")[1])
                           if existing else 0)
        # boot-time tail seal: a torn final line must not swallow the next
        # append by concatenating onto the half-line, so the damaged
        # segment is retired (never rewritten) and a fresh one starts
        if existing:
            tail = existing[-1].read_bytes()
            if tail and not tail.endswith(b"\n"):
                self._seg_index += 1
                METRICS.increment("capture.sealed_segments")
        # appended records are durable before append() returns; "a" mode
        # means a crash (or injected damage) can only cost tail records
        self._fh = open(self._active_path(), "a", encoding="utf-8")
        self._publish_gauges()

    # ---------------------------------------------------------------- paths
    def _active_path(self) -> Path:
        return self.directory / (_SEGMENT_FMT % self._seg_index)

    def segments(self) -> list[Path]:
        """All segment files, oldest first."""
        return sorted(self.directory.glob("capture-*.jsonl"))

    # --------------------------------------------------------------- writes
    def append(self, rec: dict) -> None:
        """Durably append one record (fsync'd before returning)."""
        line = _frame(dict(rec))
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            METRICS.increment("online.captured_records")
            # chaos: damage the segment AFTER the durable append — a bad
            # medium under the per-record checksums, which replay must
            # absorb record-by-record (never losing the whole store)
            spec = FAULTS.check("capture.write")
            if spec is not None:
                self._fh.close()
                corrupt_file(self._active_path(), spec.kind)
                self._fh = open(self._active_path(), "a", encoding="utf-8")
            if self._fh.tell() >= self.segment_bytes:
                self._rotate_locked()
            self._publish_gauges_locked()

    def _rotate_locked(self) -> None:
        self._fh.close()
        self._seg_index += 1
        self._fh = open(self._active_path(), "a", encoding="utf-8")

    # ---------------------------------------------------------------- reads
    def replay(self) -> Iterator[dict]:
        """Yield every verifiable record, oldest first.

        Torn-tail tolerant: a line that does not parse, is mis-framed,
        or fails its checksum is SKIPPED (counted in
        ``capture.corrupt_records``) — replay never raises on damage,
        only on the injected ``capture.replay`` round fault.
        """
        FAULTS.maybe_fire("capture.replay")
        for seg in self.segments():
            try:
                text = seg.read_text(encoding="utf-8", errors="replace")
            except OSError:
                continue
            for line in text.splitlines():
                rec = self._verify_line(line)
                if rec is not None:
                    yield rec

    def _verify_line(self, line: str) -> dict | None:
        line = line.strip()
        if not line:
            return None
        try:
            framed = json.loads(line)
            sha, rec = framed["sha"], framed["rec"]
            body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
            if hashlib.sha256(body.encode()).hexdigest()[:16] != sha:
                raise ValueError("checksum mismatch")
            return rec
        except (ValueError, KeyError, TypeError):
            METRICS.increment("capture.corrupt_records")
            return None

    def replay_tenant(self, tenant: str | None) -> Iterator[dict]:
        """Replay filtered to one tenant's traffic (``None`` matches
        records served without a tenant).  The server stamps the RAW
        tenant id on every capture record (the bounded fold applies to
        metric names only)."""
        for rec in self.replay():
            if rec.get("tenant") == tenant:
                yield rec

    def records(self) -> list[dict]:
        return list(self.replay())

    # -------------------------------------------------------------- gauges
    def _publish_gauges(self) -> None:
        with self._lock:
            self._publish_gauges_locked()

    def _publish_gauges_locked(self) -> None:
        total = sum(p.stat().st_size for p in self.segments())
        METRICS.gauge("capture.bytes", total)
        METRICS.gauge("capture.segments", self._seg_index + 1)

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "CaptureStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return sum(1 for _ in self.replay())
