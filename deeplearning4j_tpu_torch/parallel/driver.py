"""Driver: the single-controller training entry point.

Port of ``deeplearning4j_tpu/parallel/driver.py``.  Names and owns the role
the reference sketches twice — the Spark prototype
(``spark/spark-cdh5/.../multilayer/PrototypeSparkJob.java``: the driver
program holds the model, farms batches out, folds results back) and the
YARN ``ComputableMaster`` superstep — as one object per rank that owns the
mesh, the SPMD train step (collectives are the data plane; no per-batch
shipping), multi-host bootstrap, checkpointing, and observability.  One
object, one ``run()``:

    driver = Driver(loss_fn, T.chain(T.momentum(0.9), T.sgd_lr(1e-2)),
                    mesh_spec=MeshSpec(dp=8),
                    checkpoint_dir="/tmp/ckpt")
    state, losses = driver.run(params, batches, epochs=2)

Every rank of the process group runs the same program (``multihost=True``
joins the group from ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK``); the mesh is built over the world's ranks, where the reference's
is built over ``jax.devices()``.  Without a process group the world is
this one rank.  The step runs on ``device``: the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

from ..observability import METRICS, StatusServer, sample_device_memory, trace
from ..resilience import RetryPolicy, TrainingSupervisor
from .checkpoint import CheckpointManager
from .mesh import MeshSpec, initialize_multihost, make_mesh, rank_devices
from .trainer import DataParallelTrainer, TrainState


class Driver:
    """Single-controller driver over a mesh of ranks.

    ``mesh_spec=None`` uses every rank of the world as pure data
    parallelism; pass ``multihost=True`` to join the process group first
    (env-var contract, see ``initialize_multihost``) so the same driver
    program runs on every rank of a cluster.

    ``retry_policy`` (requires ``checkpoint_dir``) routes ``run`` through
    a :class:`~..resilience.TrainingSupervisor`: bounded retry with
    backoff, resume from the newest valid checkpoint, NaN/Inf rollback,
    and SIGTERM/SIGINT emergency checkpointing (DESIGN.md §12).
    """

    def __init__(self, loss_fn, transform, *, mesh_spec: MeshSpec | None = None,
                 multihost: bool = False, router: str = "iterative_reduce",
                 checkpoint_dir: str | Path | None = None,
                 checkpoint_every: int = 0, status_port: int | None = None,
                 retry_policy: RetryPolicy | None = None, device=None):
        if multihost:
            initialize_multihost()
        devices = rank_devices()
        if mesh_spec is None:
            mesh_spec = MeshSpec(dp=len(devices))
        # resolve wildcard (-1) axes against the rank pool before sizing
        sizes = mesh_spec.resolve(len(devices))
        n = 1
        for v in sizes.values():
            n *= v
        self.mesh = make_mesh(mesh_spec, devices=devices[:n])
        self.trainer = DataParallelTrainer(loss_fn, transform, mesh=self.mesh,
                                           router=router, device=device)
        self.checkpoint_manager = (CheckpointManager(checkpoint_dir)
                                   if checkpoint_dir else None)
        self.checkpoint_every = checkpoint_every
        if retry_policy is not None and self.checkpoint_manager is None:
            raise ValueError(
                "retry_policy requires checkpoint_dir — supervised recovery "
                "resumes from checkpoints")
        self.retry_policy = retry_policy
        self.status_server = None
        if status_port is not None:
            self.status_server = StatusServer(port=status_port).start()

    def run(self, params, batches: Iterable, *, epochs: int = 1,
            resume: bool = True, key=None) -> tuple[TrainState, list[float]]:
        """Fit to completion (with auto-resume when a checkpoint manager is
        configured); returns the final state and per-step losses.

        With a ``retry_policy``, runs under the self-healing supervisor —
        ``batches`` must then be re-iterable (a retried attempt replays
        the stream from the checkpoint's data cursor)."""
        with trace.span("driver.run", epochs=epochs):
            if self.retry_policy is not None:
                supervisor = TrainingSupervisor(
                    self.checkpoint_manager, self.retry_policy)
                state, losses = supervisor.fit(
                    self.trainer, params, batches, epochs=epochs,
                    checkpoint_every=max(1, self.checkpoint_every), key=key)
            else:
                state = self.trainer.init_state(params, key=key)
                # fit streams any iterable — no list() materialization;
                # one-shot generators make a single pass (multi-epoch
                # needs re-iterables)
                state, losses = self.trainer.fit(
                    state, batches, epochs=epochs,
                    checkpoint_manager=self.checkpoint_manager,
                    checkpoint_every=self.checkpoint_every, resume=resume)
        METRICS.increment("driver.steps", len(losses))
        if losses:
            METRICS.gauge("driver.loss", losses[-1])
        sample_device_memory()
        return state, losses

    def final_params(self, state: TrainState):
        return self.trainer.final_params(state)

    def close(self) -> None:
        if self.status_server is not None:
            self.status_server.stop()
