"""Replica abstraction + the health-probing, breaker-tripping pool.

Port of ``deeplearning4j_tpu/serving/router/replicas.py``.  A
:class:`Replica` is one serving backend reduced to what the router needs:
``generate`` / ``healthz`` / ``metrics_prom`` / ``reload``.

- :class:`EngineReplica` — an in-process
  :class:`~..engine.InferenceEngine`; it shares the router's registry,
  so its ``metrics_prom`` is ``""`` (federation is for process replicas).
- :class:`ProcessReplica` — a spawned child running ``python -m
  deeplearning4j_tpu_torch.serving.router.procserver`` (a real
  ``ModelServer`` process) reached through
  :class:`~..client.ServingClient`.  The factory travels as a
  ``"module:callable"`` string, the bound port comes back through a port
  file (the boot barrier), and a SIGKILL'd child surfaces as
  :class:`ReplicaUnavailable` within the client timeout — never a hang.

:class:`ReplicaPool` owns per-replica breaker state: ``fail_threshold``
consecutive failures (probe or dispatch) trip ACTIVE → QUARANTINED (a
flight-recorder bundle naming the replica and its last probe);
``recover_threshold`` consecutive probe successes re-admit.  The prober
thread also publishes ``router.*`` gauges, among them the pool-weighted
prefix hit rate (Σhits / Σlookups over the replicas).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

from ...observability import METRICS
from ...resilience.faults import FAULTS
from ..batcher import ServingRejected
from ..client import ServingClient, ServingError


class ReplicaUnavailable(ServingRejected):
    """The replica could not be reached (connection refused/reset, probe
    timeout, injected ``router.replica_down``).  503: the request was
    never admitted anywhere, so the caller may safely retry."""

    status = 503


class AllReplicasUnavailable(ServingRejected):
    """Every ring node was quarantined, unreachable, or shedding."""

    status = 503


def replica_down(name: str) -> bool:
    """Chaos seam: does ``router.replica_down`` target this replica now?
    ``FaultSpec.kind`` names the target; the default payload (and "any")
    match every replica."""
    spec = FAULTS.check("router.replica_down")
    return spec is not None and spec.kind in ("any", "bitflip", name)


class Replica:
    """One serving backend; methods raise :class:`ServingRejected`
    subclasses (``.status`` is the HTTP answer) or
    :class:`ReplicaUnavailable` for transport-level death."""

    def __init__(self, name: str):
        self.name = name

    def generate(self, payload: dict, timeout_s: float) -> dict:
        raise NotImplementedError

    def healthz(self, timeout_s: float) -> dict:
        raise NotImplementedError

    def metrics_prom(self, timeout_s: float) -> str:
        raise NotImplementedError

    def reload(self, step: int | None = None) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class EngineReplica(Replica):
    """In-process replica over an :class:`~..engine.InferenceEngine`.

    ``own_engine=True`` (the pool built it) means ``close()`` stops it.
    """

    def __init__(self, name: str, engine, own_engine: bool = False):
        super().__init__(name)
        self.engine = engine
        self._own = own_engine

    def generate(self, payload: dict, timeout_s: float) -> dict:
        if replica_down(self.name):
            raise ReplicaUnavailable(f"replica {self.name} down (injected)")
        eos = payload.get("eos_id")
        dl = payload.get("deadline_ms")
        comp = self.engine.generate(
            payload["prompt"], int(payload.get("max_new_tokens", 16)),
            temperature=float(payload.get("temperature", 0.0)),
            seed=int(payload.get("seed", 0)),
            eos_id=int(eos) if eos is not None else None,
            deadline_ms=float(dl) if dl is not None else None,
            tenant=str(payload.get("tenant") or ""),
            priority=int(payload.get("priority", 0)),
            timeout=timeout_s)
        return {"tokens": comp.tokens, "finish_reason": comp.finish_reason,
                "latency_s": comp.latency_s, "ttft_s": comp.ttft_s}

    def healthz(self, timeout_s: float) -> dict:
        if replica_down(self.name):
            raise ReplicaUnavailable(f"replica {self.name} down (injected)")
        return {"ok": True, "engine": self.engine.stats()}

    def metrics_prom(self, timeout_s: float) -> str:
        return ""  # in-process replicas share the router's own registry

    def reload(self, step: int | None = None) -> int:
        return self.engine.reload(step=step)

    def close(self) -> None:
        if self._own:
            self.engine.stop()


class ProcessReplica(Replica):
    """A spawned ``ModelServer`` child behind a :class:`ServingClient`.

    ``factory_spec`` is a ``"module:callable"`` string resolved in the
    child; the callable gets ``factory_kwargs`` and returns an (unstarted)
    ``InferenceEngine``.  ``boot_timeout_s`` covers the child's torch
    import, CUDA context, weight init and warmup; a child on the card
    loads the kernels the parent built (hash-named libraries under the
    package's build directory).
    """

    def __init__(self, name: str, factory_spec: str, workdir: str | Path,
                 factory_kwargs: dict | None = None,
                 env: dict[str, str] | None = None,
                 boot_timeout_s: float = 120.0,
                 client_timeout_s: float = 60.0,
                 trace_out: str | Path | None = None):
        super().__init__(name)
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        port_file = self.workdir / f"{name}.port"
        self._stop_file = self.workdir / f"{name}.stop"
        child_env = dict(os.environ)
        if env:
            child_env.update(env)
        # make the package importable in the child regardless of parent cwd
        pkg_root = str(Path(__file__).resolve().parents[3])
        child_env["PYTHONPATH"] = (pkg_root + os.pathsep
                                   + child_env.get("PYTHONPATH", ""))
        argv = [sys.executable, "-m",
                "deeplearning4j_tpu_torch.serving.router.procserver",
                "--name", name, "--port-file", str(port_file),
                "--stop-file", str(self._stop_file),
                "--factory", factory_spec,
                "--factory-json", json.dumps(factory_kwargs or {})]
        if trace_out is not None:
            argv += ["--trace-out", str(trace_out)]
        log = open(self.workdir / f"{name}.log", "wb")
        try:
            self.proc = subprocess.Popen(argv, env=child_env, stdout=log,
                                         stderr=subprocess.STDOUT)
        finally:
            log.close()
        self.port = self._await_port(port_file, boot_timeout_s)
        self.client = ServingClient(port=self.port,
                                    timeout_s=client_timeout_s)
        # dedicated no-retry transport for metric scrapes: the default
        # client retries idempotent GETs once with backoff, so a child
        # SIGKILL'd mid-scrape would cost TWO socket timeouts plus the
        # backoff — past the fleet scraper's per-replica budget.  One
        # attempt bounds a dead scrape to exactly one ``timeout_s``.
        self._scrape_client = ServingClient(port=self.port,
                                            timeout_s=client_timeout_s,
                                            retries=0)

    def _await_port(self, port_file: Path, timeout_s: float) -> int:
        """Boot barrier: the child writes its bound port atomically once
        the engine + server are actually up."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica {self.name} exited rc={self.proc.returncode} "
                    f"before binding (see {self.workdir / (self.name + '.log')})")
            if port_file.exists():
                text = port_file.read_text().strip()
                if text:
                    return int(text)
            time.sleep(0.05)
        self.proc.kill()
        raise TimeoutError(f"replica {self.name} did not boot "
                           f"within {timeout_s}s")

    def generate(self, payload: dict, timeout_s: float) -> dict:
        if replica_down(self.name):
            raise ReplicaUnavailable(f"replica {self.name} down (injected)")
        try:
            return self.client.generate(
                payload["prompt"],
                int(payload.get("max_new_tokens", 16)),
                temperature=float(payload.get("temperature", 0.0)),
                seed=int(payload.get("seed", 0)),
                eos_id=payload.get("eos_id"),
                deadline_ms=payload.get("deadline_ms"),
                tenant=payload.get("tenant"),
                priority=int(payload.get("priority", 0) or 0),
                timeout_s=timeout_s)
        except OSError as e:
            # connection refused/reset or socket timeout: the child is
            # dead or wedged — fail fast, the router decides what's next.
            # (ServingError is NOT an OSError: an answered error keeps
            # its HTTP status and is re-raised untouched.)
            raise ReplicaUnavailable(
                f"replica {self.name} unreachable: {e}") from e

    def healthz(self, timeout_s: float) -> dict:
        if replica_down(self.name):
            raise ReplicaUnavailable(f"replica {self.name} down (injected)")
        try:
            return self.client.healthz(timeout_s=timeout_s)
        except OSError as e:
            raise ReplicaUnavailable(
                f"replica {self.name} unreachable: {e}") from e

    def metrics_prom(self, timeout_s: float) -> str:
        # a child that already exited can never answer: short-circuit
        # before paying any socket timeout (SIGKILL leaves no listener,
        # but a half-closed accept queue can still absorb a connect)
        if self.proc.poll() is not None:
            raise ReplicaUnavailable(
                f"replica {self.name} dead (rc={self.proc.returncode})")
        try:
            return self._scrape_client.metrics_prom(timeout_s=timeout_s)
        except OSError as e:
            raise ReplicaUnavailable(
                f"replica {self.name} unreachable: {e}") from e

    def reload(self, step: int | None = None) -> int:
        return self.client.reload(step)

    def kill(self) -> None:
        """SIGKILL the child (chaos tests): no goodbye, probes just fail."""
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=10.0)

    def close(self) -> None:
        try:
            self._stop_file.touch()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10.0)


ACTIVE = "active"
QUARANTINED = "quarantined"
DRAINING = "draining"   # administrative quarantine: scale-in in progress


class _ReplicaState:
    """Breaker bookkeeping for one replica (all fields guarded by the
    pool lock)."""

    __slots__ = ("state", "consecutive_failures", "consecutive_successes",
                 "inflight", "last_probe", "quarantines")

    def __init__(self):
        self.state = ACTIVE
        self.consecutive_failures = 0
        self.consecutive_successes = 0
        self.inflight = 0
        self.last_probe: dict = {}
        self.quarantines = 0


class ReplicaPool:
    """N replicas + breaker state + a background health prober.

    Lock discipline: ``self._lock`` guards only the state table and is a
    leaf — probes and dispatches (blocking HTTP / engine calls) always
    happen OUTSIDE it.
    """

    def __init__(self, replicas: list[Replica],
                 probe_interval_s: float = 0.5,
                 probe_timeout_s: float = 2.0,
                 fail_threshold: int = 2,
                 recover_threshold: int = 2):
        if not replicas:
            raise ValueError("need at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.fail_threshold = fail_threshold
        self.recover_threshold = recover_threshold
        self._replicas: dict[str, Replica] = {r.name: r for r in replicas}
        self._lock = threading.Lock()
        self._state = {r.name: _ReplicaState() for r in replicas}  # guarded-by: self._lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        for name in self._replicas:
            METRICS.gauge(f"router.replica_state.{name}", 1.0)

    # ------------------------------------------------------------ membership
    def names(self) -> list[str]:
        return list(self._replicas)

    def replica(self, name: str) -> Replica:
        return self._replicas[name]

    def is_active(self, name: str) -> bool:
        with self._lock:
            st = self._state.get(name)
            return st is not None and st.state == ACTIVE

    def active_names(self) -> list[str]:
        with self._lock:
            return [n for n, st in self._state.items() if st.state == ACTIVE]

    def last_probe(self, name: str) -> dict:
        with self._lock:
            return dict(self._state[name].last_probe)

    def inflight(self, name: str) -> int:
        with self._lock:
            st = self._state.get(name)
            return st.inflight if st is not None else 0

    # --------------------------------------------------- elastic membership
    #
    # The scale seams.  ``_replicas`` is mutated copy-on-
    # write under ``_lock`` — dispatch and the prober read it LOCKLESS, so
    # they must always see a complete dict, never a half-mutated one.
    # Scale-in reuses the quarantine state machine: ``drain_replica`` parks
    # the replica in DRAINING (``is_active`` false — routing drains its
    # keys to the clockwise ring successors exactly as a breaker trip
    # would, and probes can never re-admit it), and ``remove_replica``
    # refuses until the drain finished (zero in flight) — a half-drained
    # replica is unrepresentable.

    def add_replica(self, replica: Replica) -> None:
        """Admit a NEW replica into the pool (ACTIVE).  The caller is
        responsible for warming it first — see ``PrefixRouter.scale_up``,
        which gates ring admission on the replica's warmed health flag."""
        with self._lock:
            if replica.name in self._replicas:
                raise ValueError(f"replica {replica.name!r} already pooled")
            self._replicas = {**self._replicas, replica.name: replica}
            self._state[replica.name] = _ReplicaState()
        METRICS.increment("router.replicas_added")
        METRICS.gauge(f"router.replica_state.{replica.name}", 1.0)

    def drain_replica(self, name: str) -> None:
        """Begin scale-in: stop routing to ``name`` (quarantine-path
        semantics — its ring segment drains to clockwise successors) while
        in-flight requests finish.  Idempotent."""
        with self._lock:
            st = self._state[name]
            already = st.state == DRAINING
            st.state = DRAINING
            inflight = st.inflight
        if already:
            return
        METRICS.increment("router.drains")
        METRICS.gauge(f"router.replica_state.{name}", 0.0)
        from ...observability import FLIGHTREC
        FLIGHTREC.dump("router_replica_drain",
                       extra={"replica": name, "inflight": inflight})

    def reactivate_replica(self, name: str) -> None:
        """Abort a drain (scale-in timed out or was cancelled): the
        replica returns to ACTIVE and its ring segment snaps back to the
        original assignment — fail safe is *more* capacity, never a
        half-drained replica."""
        with self._lock:
            st = self._state[name]
            if st.state != DRAINING:
                return
            st.state = ACTIVE
            st.consecutive_failures = 0
        METRICS.increment("router.drain_aborts")
        METRICS.gauge(f"router.replica_state.{name}", 1.0)

    def remove_replica(self, name: str) -> Replica:
        """Complete scale-in: detach a fully drained replica and return
        it (the caller owns ``close()``).  Refuses while the replica is
        still ACTIVE or has requests in flight."""
        with self._lock:
            st = self._state.get(name)
            if st is None:
                raise KeyError(name)
            if st.state == ACTIVE:
                raise RuntimeError(
                    f"replica {name!r} is ACTIVE — drain_replica() first")
            if st.inflight:
                raise RuntimeError(
                    f"replica {name!r} still has {st.inflight} request(s) "
                    "in flight — drain must finish before removal")
            replicas = dict(self._replicas)
            rep = replicas.pop(name)
            self._replicas = replicas
            del self._state[name]
        METRICS.increment("router.replicas_removed")
        METRICS.gauge(f"router.replica_state.{name}", 0.0)
        return rep

    # ------------------------------------------------------------ breaker
    def record_failure(self, name: str, reason: str) -> bool:
        """One failed probe or dispatch; returns True when this failure
        tripped the breaker (ACTIVE -> QUARANTINED)."""
        with self._lock:
            st = self._state.get(name)
            if st is None:
                return False   # removed (scale-in) while a probe ran
            st.consecutive_successes = 0
            st.consecutive_failures += 1
            tripped = (st.state == ACTIVE
                       and st.consecutive_failures >= self.fail_threshold)
            if tripped:
                st.state = QUARANTINED
                st.quarantines += 1
                last_probe = dict(st.last_probe)
                failures = st.consecutive_failures
        if tripped:
            METRICS.increment("router.quarantines")
            METRICS.gauge(f"router.replica_state.{name}", 0.0)
            # a dead replica must leave evidence: bundle names the replica
            # and the last health probe it ever answered
            from ...observability import FLIGHTREC
            FLIGHTREC.dump("router_replica_quarantine",
                           extra={"replica": name, "reason": reason,
                                  "consecutive_failures": failures,
                                  "last_probe": last_probe})
        return tripped

    def record_success(self, name: str, probe: dict | None = None) -> bool:
        """One successful probe or dispatch; returns True when it
        re-admitted a quarantined replica."""
        with self._lock:
            st = self._state.get(name)
            if st is None:
                return False   # removed (scale-in) while a probe ran
            st.consecutive_failures = 0
            st.consecutive_successes += 1
            if probe is not None:
                st.last_probe = probe
            readmitted = (st.state == QUARANTINED
                          and st.consecutive_successes
                          >= self.recover_threshold)
            if readmitted:
                st.state = ACTIVE
        if readmitted:
            METRICS.increment("router.readmissions")
            METRICS.gauge(f"router.replica_state.{name}", 1.0)
        return readmitted

    # ------------------------------------------------------------ load
    def begin_request(self, name: str) -> None:
        with self._lock:
            self._state[name].inflight += 1
            load = self._state[name].inflight
        METRICS.gauge(f"router.replica_load.{name}", float(load))

    def end_request(self, name: str) -> None:
        with self._lock:
            st = self._state.get(name)
            if st is None:
                return
            st.inflight -= 1
            load = st.inflight
        METRICS.gauge(f"router.replica_load.{name}", float(load))

    # ------------------------------------------------------------ probing
    def probe_once(self) -> None:
        """One health sweep: every replica probed (outside the lock),
        breaker state advanced, aggregate gauges published."""
        total_hits = total_lookups = 0
        have_prefix = False
        # membership is copy-on-write: this grabs one consistent snapshot,
        # so a concurrent scale-up/scale-in can never break the sweep
        for name, rep in list(self._replicas.items()):
            try:
                if replica_down(name):
                    raise ReplicaUnavailable(
                        f"replica {name} down (injected)")
                health = rep.healthz(self.probe_timeout_s)
            except (ServingRejected, ServingError, OSError) as e:
                self.record_failure(name, f"probe: {e}")
                continue
            stats = health.get("engine") or {}
            if stats.get("role") == "prefill":
                # a prefill-role replica can never decode — routing it
                # decode traffic would fail every request.  Role is in
                # the health JSON precisely so this is verifiable over
                # HTTP; treat it as a hard probe failure and let the
                # breaker keep it out of the ring
                self.record_failure(
                    name, "probe: prefill-role replica cannot serve "
                          "decode traffic")
                continue
            probe = {"time": time.time(), "health": health}
            self.record_success(name, probe=probe)
            qd = stats.get("queue_depth")
            if qd is not None:
                METRICS.gauge(f"router.replica_queue_depth.{name}",
                              float(qd))
            if "prefix_lookups" in stats:
                have_prefix = True
                total_hits += int(stats.get("prefix_hits", 0))
                total_lookups += int(stats.get("prefix_lookups", 0))
        if have_prefix:
            # pool-weighted aggregate: each in-process engine publishes
            # serving.prefix_hit_rate to the SAME global gauge, so only
            # this Σhits/Σlookups view is meaningful across replicas
            METRICS.gauge("router.prefix_hit_rate",
                          total_hits / total_lookups if total_lookups
                          else 0.0)

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            self.probe_once()
            self._stop.wait(self.probe_interval_s)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReplicaPool":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._probe_loop,
                                            daemon=True,
                                            name="router-prober")
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        for rep in self._replicas.values():
            rep.close()
