"""Prefix-affinity consistent-hash routing.

Port of ``deeplearning4j_tpu/serving/router/router.py``.  The routing key
is the request's content-addressed prefix chain — the same chained
blake2b the :class:`~..paging.PagePool` uses
(:func:`~..paging.prefix_chain_keys`), over full pages only — truncated
to the first ``affinity_pages`` pages, so one tenant's shared system
prompt lands on the replica that holds its KV pages.  Prompts shorter
than one full page fall back to a whole-prompt hash.

Dispatch walks the ring clockwise from the key, skipping quarantined
nodes, and degrades in order: a 429 spills to the next node
(``router.spillover``, noted in the flight recorder); a dead replica
(:class:`ReplicaUnavailable`, a timeout, a 5xx) feeds the pool's breaker
and tries the next node; a 400 / 404 / 504 is the request's own problem
and propagates.

Every attempt runs in a ``router.route`` span under one
``router.request`` span; the replica's ``serving.*`` spans join the same
trace through the ``traceparent`` the client sends.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass

from ...observability import METRICS, trace
from ...observability.flightrec import FLIGHTREC
from ...resilience.faults import FAULTS
from ..batcher import ServingRejected
from ..client import ServingError
from ..paging import prefix_chain_keys
from .replicas import (AllReplicasUnavailable, Replica, ReplicaPool,
                       ReplicaUnavailable)
from .ring import HashRing


@dataclass(frozen=True)
class RouterConfig:
    """Knobs for ring construction, affinity, spillover and the breaker."""

    page_size: int = 16          # MUST match the replicas' PagePool
    affinity_pages: int = 4      # chain prefix length the key hashes
    vnodes: int = 64             # ring points per replica
    request_timeout_s: float = 60.0
    max_spill: int | None = None  # extra nodes tried after the owner (None: all)
    probe_interval_s: float = 0.5
    probe_timeout_s: float = 2.0
    fail_threshold: int = 2      # consecutive failures -> quarantine
    recover_threshold: int = 2   # consecutive probe successes -> re-admit


class PrefixRouter:
    """Consistent-hash front tier over a :class:`ReplicaPool`."""

    def __init__(self, replicas: list[Replica],
                 cfg: RouterConfig = RouterConfig()):
        self.cfg = cfg
        self.pool = ReplicaPool(
            replicas,
            probe_interval_s=cfg.probe_interval_s,
            probe_timeout_s=cfg.probe_timeout_s,
            fail_threshold=cfg.fail_threshold,
            recover_threshold=cfg.recover_threshold)
        # the ring is immutable once published: elastic membership swaps a
        # freshly built ring ATOMICALLY (one attribute store) under
        # _ring_lock, exactly the future the HashRing docstring reserves —
        # lookups stay lockless, a reader sees the old ring or the new
        # one, never a half-mutated one
        self._ring_lock = threading.Lock()
        self.ring = HashRing(self.pool.names(), vnodes=cfg.vnodes)

    # ------------------------------------------------------------ routing
    def routing_key(self, prompt) -> str:
        """Content-addressed key for ``prompt``: the chain hash of its
        first ``affinity_pages`` FULL pages (identical to the pool's
        page addressing), else a whole-prompt fallback hash."""
        tokens = [int(t) for t in prompt]
        usable = len(tokens) - 1  # the last token is the first decode query
        keys = prefix_chain_keys(tokens, usable, self.cfg.page_size)
        if keys:
            return keys[min(len(keys), self.cfg.affinity_pages) - 1]
        return "short:" + hashlib.blake2b(
            (",".join(map(str, tokens))).encode(), digest_size=16).hexdigest()

    def route_order(self, key: str) -> list[str]:
        """Active replicas in dispatch order: the owner first, then its
        clockwise successors (the spillover / quarantine-drain order)."""
        return [n for n in self.ring.walk(key) if self.pool.is_active(n)]

    # ------------------------------------------------------------ dispatch
    def generate(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: int | None = None,
                 deadline_ms: float | None = None,
                 tenant: str | None = None,
                 priority: int = 0,
                 timeout_s: float | None = None) -> dict:
        """Route one generation; returns the replica's completion dict
        plus ``replica`` (who served it) and ``spills`` (how many nodes
        were tried before it).  ``tenant`` rides the payload opaquely —
        the serving replica folds it into bounded per-tenant metrics."""
        FAULTS.maybe_fire("router.route")
        payload = {"prompt": list(prompt), "max_new_tokens": max_new_tokens,
                   "temperature": temperature, "seed": seed}
        if eos_id is not None:
            payload["eos_id"] = eos_id
        if deadline_ms is not None:
            payload["deadline_ms"] = deadline_ms
        if tenant:
            payload["tenant"] = str(tenant)
        if priority:
            payload["priority"] = int(priority)
        timeout = timeout_s if timeout_s is not None \
            else self.cfg.request_timeout_s
        key = self.routing_key(prompt)
        with trace.span("router.request", key=key[:12]):
            order = self.route_order(key)
            if not order:
                METRICS.increment("router.unroutable")
                raise AllReplicasUnavailable(
                    "no active replicas on the ring")
            if self.cfg.max_spill is not None:
                order = order[: self.cfg.max_spill + 1]
            last_rejection: ServingRejected | None = None
            for spills, name in enumerate(order):
                try:
                    rep = self.pool.replica(name)
                except KeyError:
                    continue   # removed (scale-in) after route_order ran
                self.pool.begin_request(name)
                try:
                    with trace.span("router.route", replica=name,
                                    spills=spills):
                        out = rep.generate(payload, timeout)
                except (ReplicaUnavailable, TimeoutError) as e:
                    # transport-level death: feed the breaker, drain to
                    # the next ring node
                    METRICS.increment("router.replica_errors")
                    self.pool.record_failure(name, f"dispatch: {e}")
                    last_rejection = e if isinstance(e, ServingRejected) \
                        else ReplicaUnavailable(str(e))
                    continue
                except ServingRejected as e:
                    if e.status == 429:
                        # the owner is shedding load: spill clockwise,
                        # trading prefix locality for availability
                        METRICS.increment("router.spillover")
                        FLIGHTREC.note_spillover(name)
                        last_rejection = e
                        continue
                    raise  # 504 deadline etc.: the request's problem
                except ServingError as e:
                    if e.status == 429:
                        METRICS.increment("router.spillover")
                        FLIGHTREC.note_spillover(name)
                        last_rejection = _as_rejection(e)
                        continue
                    if e.status >= 500:
                        METRICS.increment("router.replica_errors")
                        self.pool.record_failure(name, f"dispatch: {e}")
                        last_rejection = _as_rejection(e)
                        continue
                    raise  # 400/404/409: a different replica answers the same
                finally:
                    self.pool.end_request(name)
                self.pool.record_success(name)
                METRICS.increment("router.requests")
                if spills == 0:
                    # landed on the first active ring node for its key —
                    # the replica whose PagePool holds this prefix
                    METRICS.increment("router.prefix_affinity_hit")
                out["replica"] = name
                out["spills"] = spills
                return out
            raise last_rejection if last_rejection is not None else \
                AllReplicasUnavailable("all replicas failed")

    # ------------------------------------------------------ elastic scale
    def scale_up(self, replica: Replica, warm_timeout_s: float = 120.0,
                 poll_s: float = 0.05) -> None:
        """Admit a freshly built replica: wait for its engine to report
        ``warmed`` over ``/healthz``, THEN add it to the pool and publish
        a new ring.  The warm gate is the whole point — a cold replica on
        the ring inherits its keyspace segment immediately and every
        request it receives pays the kernel build and first launches.
        On warm timeout the
        replica is NOT admitted (and is closed): fail safe is the old
        capacity, never a cold ring node."""
        try:
            self._await_warm(replica, warm_timeout_s, poll_s)
        except Exception:
            replica.close()
            raise
        self.pool.add_replica(replica)
        with self._ring_lock:
            self.ring = HashRing(self.pool.names(), vnodes=self.cfg.vnodes)
        METRICS.increment("router.scale_up")
        METRICS.gauge("router.pool_size", float(len(self.pool.names())))

    def scale_down(self, name: str, drain_timeout_s: float = 30.0,
                   poll_s: float = 0.02) -> Replica:
        """Drain-and-remove ``name``: quarantine-path drain first (its
        ring segment spills to the clockwise successors while in-flight
        requests finish), then detach and publish a ring without it.
        Returns the detached replica — the caller owns ``close()``.  On
        drain timeout the replica is REACTIVATED and the call raises:
        the pool can end up bigger than intended, never half-drained."""
        if len(self.pool.names()) <= 1:
            raise RuntimeError("refusing to scale down the last replica")
        self.pool.drain_replica(name)
        deadline = time.monotonic() + drain_timeout_s
        while self.pool.inflight(name) > 0:
            if time.monotonic() > deadline:
                self.pool.reactivate_replica(name)
                raise TimeoutError(
                    f"replica {name!r} did not drain within "
                    f"{drain_timeout_s}s — reactivated (fail safe)")
            time.sleep(poll_s)
        rep = self.pool.remove_replica(name)
        with self._ring_lock:
            self.ring = HashRing(self.pool.names(), vnodes=self.cfg.vnodes)
        METRICS.increment("router.scale_down")
        METRICS.gauge("router.pool_size", float(len(self.pool.names())))
        return rep

    @staticmethod
    def _await_warm(replica: Replica, timeout_s: float,
                    poll_s: float) -> None:
        """Block until the replica's health answer carries a truthy
        engine ``warmed`` flag (set at the END of ``warmup()``: the
        kernels built and a decode step run)."""
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                health = replica.healthz(min(timeout_s, 5.0))
                if bool((health.get("engine") or {}).get("warmed")):
                    return
            except (ServingRejected, ServingError, OSError):
                pass   # still booting — keep polling until the deadline
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {replica.name!r} not warmed within "
                    f"{timeout_s}s — refusing ring admission")
            time.sleep(poll_s)

    # ------------------------------------------------------------ admin
    def reload(self, step: int | None = None) -> dict[str, int]:
        """Hot-reload every ACTIVE replica (to ``step`` when given — the
        online loop's fan-out and rollback path); name -> loaded step."""
        return {name: self.pool.replica(name).reload(step)
                for name in self.pool.active_names()}

    def stats(self) -> dict:
        """Router-level view: per-replica breaker state + load."""
        out = {}
        for name in self.pool.names():
            out[name] = {"active": self.pool.is_active(name),
                         "last_probe": self.pool.last_probe(name)}
        return out

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "PrefixRouter":
        self.pool.start()
        return self

    def close(self) -> None:
        self.pool.close()

    def __enter__(self) -> "PrefixRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def _as_rejection(e: ServingError) -> ServingRejected:
    """Carry a downstream HTTP rejection's status through the router."""
    rej = ServingRejected(str(e))
    rej.status = e.status
    return rej
