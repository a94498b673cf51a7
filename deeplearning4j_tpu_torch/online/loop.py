"""The online learning coordinator.

Port of ``deeplearning4j_tpu/online/loop.py``.  One dataflow across both
halves of the stack: replay the :class:`~.capture.CaptureStore`,
fine-tune through the supervised training stack (``TrainingSupervisor``
over a one-device ``DataParallelTrainer`` on the engine's device),
publish manifest-verified checkpoints, and hot-reload each new
``latest_valid_step()`` into live serving at generation-consistent
fences.  Every applied generation is canaried and SLO-gated: a
non-finite or regressed canary loss, or an SLO burn-rate breach during
the probation window, quarantines the step and rolls serving back to the
previous valid generation, with a flight-recorder bundle naming the step.

Replay is the cursor: each round replays the whole capture history into
a prefix-stable batch stream (records pack into fixed ``(batch, seq+1)``
blocks in append order, partial tails left out), and the trainer's
checkpoint data cursor skips every batch already trained, so a round
trains exactly the new tail.  A bootstrap checkpoint of the initial
params is published at step 0 before the first round, so a rollback
always has a generation to land on.

Chaos sites: ``online.publish`` (transient abort, or ``kind="poison"``:
the published params are rewritten with NaN under recomputed checksums,
a manifest-valid model the gates must catch), ``online.reload``
(transient abort before the swap), and ``online.rollback`` (transient
failures inside rollback, retried while the site fires).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Any

import numpy as np
import torch

from ..models.transformer import lm_loss_local
from ..observability import FLIGHTREC, METRICS
from ..optimize import transforms as tfm
from ..parallel.trainer import DataParallelTrainer
from ..resilience.faults import FAULTS, InjectedFault
from ..resilience.supervisor import RetryPolicy, TrainingSupervisor


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Knobs for one :class:`OnlineLoop`."""

    batch: int = 2                  # rows per training batch
    seq: int = 16                   # tokens per training row
    epochs: int = 1                 # passes per round (1: replay-is-cursor)
    learning_rate: float = 1e-2
    canary_factor: float = 2.0      # loss regression multiple that fails
    probation_s: float = 0.0        # SLO watch window after each swap
    probation_poll_s: float = 0.05
    rollback_attempts: int = 8      # bounded retries through online.rollback
    min_feedback: float = 0.0       # records with feedback < this are skipped


@dataclasses.dataclass
class RoundReport:
    """What one :meth:`OnlineLoop.run_once` did (JSON-safe)."""

    status: str = "ok"              # ok | no_new_data | *_fault | rolled_back
    base_step: int = 0
    trained_to: int | None = None
    reloaded: dict = dataclasses.field(default_factory=dict)
    rolled_back: bool = False
    rollback_reason: str | None = None
    quarantined: str | None = None
    generation: int = 0
    faults: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class OnlineLoop:
    """serve → capture → fine-tune → hot-reload, with SLO-gated rollback.

    ``engine`` and/or ``router`` are the reload fan-out targets; both are
    optional (a loop with neither still trains and publishes).  ``slo``
    is an attached :class:`~..observability.slo.SLOEvaluator` whose
    breach count gates the post-swap probation window.  ``params0`` must
    be the SAME tree the serving side was built with: it seeds the
    bootstrap step-0 checkpoint, making the pre-training generation a
    valid rollback target.  Without it the loop draws ``model.init``
    from a CPU ``torch.Generator`` seeded 0.  Training and the canary run
    on the engine's device, else the model's.
    """

    def __init__(self, store, manager, model, *, params0=None,
                 engine=None, router=None, cfg: OnlineConfig = OnlineConfig(),
                 slo=None, supervisor: TrainingSupervisor | None = None,
                 optimizer=None):
        self.store = store
        self.manager = manager
        self.model = model
        self.engine = engine
        self.router = router
        self.cfg = cfg
        self.slo = slo
        self.supervisor = supervisor or TrainingSupervisor(
            checkpoint_manager=manager,
            policy=RetryPolicy(max_attempts=4, backoff_base_s=0.01),
            install_signal_handlers=False)
        if self.supervisor.manager is None:
            self.supervisor.manager = manager
        self._params0 = params0
        self._optimizer = optimizer
        self._trainer: DataParallelTrainer | None = None
        self._canary_batch: tuple | None = None
        self._canary_baseline: float | None = None
        self.generation = 0             # applied forward swaps + rollbacks
        self._current_step: int | None = (
            engine.stats().get("loaded_step") if engine is not None else None)
        self._round_lock = threading.Lock()
        self._rounds = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ plumbing
    def _device(self):
        return (self.engine.device if self.engine is not None
                else self.model.device)

    def _initial_params(self):
        if self._params0 is None:
            self._params0 = self.model.init(torch.Generator().manual_seed(0))
        return self._params0

    def _make_trainer(self) -> DataParallelTrainer:
        if self._trainer is None:
            mcfg = self.model.cfg

            def loss(p, xb, yb, gen=None):
                return lm_loss_local(p, xb, yb, mcfg)

            tx = self._optimizer or tfm.sgd_lr(self.cfg.learning_rate)
            self._trainer = DataParallelTrainer(loss, tx,
                                                device=self._device())
        return self._trainer

    def _ensure_bootstrap(self) -> None:
        """Publish the initial params as step 0 once — rollback's floor."""
        if self.manager.latest_valid_step() is None:
            self.manager.save(0, self._initial_params())

    # ------------------------------------------------------------- packing
    def _keep(self, rec: dict) -> bool:
        fb = rec.get("feedback")
        if fb is None:
            return True
        if isinstance(fb, bool):
            return fb
        try:
            return float(fb) >= self.cfg.min_feedback
        except (TypeError, ValueError):
            return True

    def _pack(self, records: list[dict]) -> list[tuple]:
        """Prefix-stable batches: records concatenate (prompt + tokens)
        into one flat stream in append order, sliced into fixed
        ``seq+1``-token rows, grouped into full ``batch``-row batches —
        appending records NEVER changes an earlier batch, so the
        checkpoint data cursor (= batches already trained) is exact."""
        flat: list[int] = []
        for r in records:
            if self._keep(r):
                flat.extend(int(t) for t in r.get("prompt", []))
                flat.extend(int(t) for t in r.get("tokens", []))
        block = self.cfg.seq + 1
        rows = [flat[i * block:(i + 1) * block]
                for i in range(len(flat) // block)]
        out = []
        for i in range(len(rows) // self.cfg.batch):
            chunk = np.asarray(rows[i * self.cfg.batch:(i + 1) * self.cfg.batch],
                               np.int32)
            out.append((chunk[:, :-1], chunk[:, 1:]))
        return out

    # ------------------------------------------------------------ one round
    def run_once(self, key=None) -> RoundReport:
        with self._round_lock:
            return self._run_once_locked(key)

    def _run_once_locked(self, key) -> RoundReport:
        rep = RoundReport(generation=self.generation)
        self._ensure_bootstrap()
        rep.base_step = base_step = self.manager.latest_valid_step() or 0
        self._rounds += 1
        METRICS.increment("online.rounds")

        # ---- fine-tune phase: replay everything, train the new tail
        try:
            batches = self._pack(list(self.store.replay()))
        except InjectedFault as e:
            rep.faults.append(f"capture.replay: {e}")
            batches = []
        if batches:
            self._canary_batch = batches[-1]
            if len(batches) > base_step:
                trainer = self._make_trainer()
                self.supervisor.fit(trainer, self._initial_params(), batches,
                                    epochs=self.cfg.epochs,
                                    checkpoint_every=1, key=key)

        new_step = self.manager.latest_valid_step()
        rep.trained_to = new_step
        if new_step is None or new_step <= (self._current_step or 0):
            rep.status = "no_new_data"
            return rep

        # ---- publish gate (chaos): transient aborts the round (the
        # checkpoint stays; the NEXT round's reload picks it up); poison
        # rewrites the published params under valid checksums — the
        # exact failure the canary/SLO gates exist for
        spec = FAULTS.check("online.publish")
        if spec is not None:
            if spec.kind == "poison":
                rep.faults.append("online.publish: poison")
                self._poison_checkpoint(new_step)
            else:
                rep.faults.append("online.publish: transient")
                rep.status = "publish_fault"
                return rep

        # ---- hot reload fan-out
        try:
            FAULTS.maybe_fire("online.reload")
        except InjectedFault as e:
            rep.faults.append(f"online.reload: {e}")
            rep.status = "reload_fault"
            return rep
        t0 = time.perf_counter()
        rep.reloaded = self._reload_targets(new_step)
        METRICS.gauge("online.reload_seconds", time.perf_counter() - t0)
        METRICS.increment("online.reloads")
        self._current_step = new_step
        self.generation += 1
        rep.generation = self.generation
        METRICS.gauge("online.generation", self.generation)

        # ---- canary + SLO probation; breach => rollback
        reason = self._canary(new_step)
        if reason is None and self._probation_breached():
            reason = "slo_breach"
        if reason is not None:
            self._rollback(new_step, reason, rep)
        return rep

    def _reload_targets(self, step: int) -> dict:
        out: dict[str, Any] = {}
        if self.engine is not None:
            out["engine"] = self.engine.reload(step=step)
        if self.router is not None:
            out.update(self.router.reload(step=step))
        return out

    # ------------------------------------------------------------- canary
    def _canary(self, step: int) -> str | None:
        """Gate the freshly-loaded generation on a held-out loss: restore
        the PUBLISHED bytes (what serving actually loaded, not the
        trainer's in-memory state) and score the newest packed batch.
        Non-finite, or worse than ``canary_factor`` × the best loss seen,
        fails the canary.  Returns the failure reason or None."""
        if self._canary_batch is None:
            return None
        try:
            restored = self.manager.restore(self._initial_params(),
                                            step=step)["params"]
            x, y = (torch.as_tensor(a, device=self._device())
                    for a in self._canary_batch)
            with torch.no_grad():
                loss = float(lm_loss_local(restored, x, y, self.model.cfg))
        except Exception as e:                     # noqa: BLE001
            return f"canary_error: {type(e).__name__}: {e}"
        METRICS.gauge("online.canary_loss", loss)
        if not np.isfinite(loss):
            return "canary_nonfinite"
        base = self._canary_baseline
        if base is not None and loss > self.cfg.canary_factor * max(base, 1e-8):
            return f"canary_regression: {loss:.4f} > " \
                   f"{self.cfg.canary_factor} * {base:.4f}"
        self._canary_baseline = loss if base is None else min(base, loss)
        return None

    def _probation_breached(self) -> bool:
        """Watch the SLO evaluator's breach count over the probation
        window; any NEW breach after the swap condemns the generation."""
        if self.slo is None or self.cfg.probation_s <= 0:
            return False
        start = self.slo.status()["breaches"]
        t_end = time.monotonic() + self.cfg.probation_s
        while time.monotonic() < t_end:
            if self.slo.status()["breaches"] > start:
                return True
            time.sleep(self.cfg.probation_poll_s)
        return self.slo.status()["breaches"] > start

    # ------------------------------------------------------------ rollback
    def _rollback(self, bad_step: int, reason: str, rep: RoundReport) -> None:
        """Quarantine ``bad_step`` and swing serving back to the previous
        valid generation.  The ``online.rollback`` chaos site injects
        transient failures INSIDE the recovery path — retried (bounded by
        ``rollback_attempts`` and the site's ``max_fires``) because
        rollback is the one step that must not stay failed."""
        for _ in range(self.cfg.rollback_attempts):
            try:
                FAULTS.maybe_fire("online.rollback")
                break
            except InjectedFault as e:
                rep.faults.append(f"online.rollback: {e}")
        bad_dir = self.manager.quarantine(bad_step)
        rep.quarantined = str(bad_dir)
        prev = self.manager.latest_valid_step()
        if prev is not None:
            rep.reloaded = self._reload_targets(prev)
            self._current_step = prev
        self.generation += 1
        rep.generation = self.generation
        METRICS.gauge("online.generation", self.generation)
        METRICS.increment("online.rollbacks")
        rep.rolled_back = True
        rep.rollback_reason = reason
        rep.status = "rolled_back"
        # the canary baseline came from a now-condemned trajectory only
        # if the bad step set it — it never did (rollback fires before
        # the baseline update), so keep it
        FLIGHTREC.dump("online_rollback", extra={
            "bad_step": int(bad_step),
            "restored_step": int(prev) if prev is not None else None,
            "reason": reason,
            "generation": self.generation,
            "quarantined": str(bad_dir),
        })

    # ------------------------------------------------------------- poison
    def _poison_checkpoint(self, step: int) -> None:
        """Chaos ``online.publish kind="poison"``: rewrite the published
        params with garbage and RECOMPUTE the manifest checksums — a
        checkpoint that verifies perfectly and serves terribly, the
        adversary the canary/SLO gates (not the manifest) must catch.
        Float leaves go NaN — the classic diverged-training artifact
        (constants would slip past the canary: layernorm makes an
        all-equal tree score a merely-uniform loss).  Rewrites go through
        a unique tempfile, fsync and ``os.replace``."""
        d = self.manager.directory / f"ckpt_{step:010d}"
        with np.load(d / "params.npz") as z:
            poisoned = {
                k: np.full_like(z[k], np.nan)
                if np.issubdtype(z[k].dtype, np.floating)
                else np.full_like(z[k], 1)
                for k in z.files}
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
        os.close(fd)
        np.savez(tmp, **poisoned)
        fd = os.open(tmp, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
        os.replace(tmp, d / "params.npz")
        meta = json.loads((d / "meta.json").read_text())
        meta["checksums"]["params.npz"] = hashlib.sha256(
            (d / "params.npz").read_bytes()).hexdigest()
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".json")
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(meta, indent=2))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, d / "meta.json")

    # ---------------------------------------------------------- background
    def start(self, interval_s: float = 0.25) -> "OnlineLoop":
        """Run rounds on a daemon thread until :meth:`stop`."""
        if self._thread is None:
            self._stop.clear()

            def _run():
                while not self._stop.is_set():
                    try:
                        self.run_once()
                    except Exception:              # noqa: BLE001
                        METRICS.increment("online.round_errors")
                    self._stop.wait(interval_s)

            self._thread = threading.Thread(target=_run, daemon=True,
                                            name="online-loop")
            self._thread.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None

    def __enter__(self) -> "OnlineLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- status
    def status(self) -> dict:
        return {
            "generation": self.generation,
            "current_step": self._current_step,
            "rounds": self._rounds,
            "canary_baseline": self._canary_baseline,
            "running": self._thread is not None,
        }
