"""A pool of spawned ranks for the smoke tools' multi-rank legs.

The reference runs its data-parallel chaos legs at ``dp=8`` on virtual
devices in one process; the port's :class:`~..parallel.DataParallelTrainer`
is SPMD over the ranks of a ``torch.distributed`` world.  :class:`RankPool`
spawns ``world`` processes (spawn context) that join one gloo group
through a ``file://`` rendezvous in a temporary directory of the pool's
own, then serve jobs: :meth:`RankPool.run` sends a job (a module-level
function named ``"module:function"``) and its arguments to every rank and
returns their results in rank order.  On ``cuda`` every rank shares card
0 (gloo carries CUDA tensors; NCCL refuses two ranks on one card).  A job
that fails on any rank, or a pool that does not answer within the
timeout, raises and kills the pool; the next job starts a new one.
With ``shardguard`` every rank runs its jobs under the port's
``SHARDGUARD``.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from pathlib import Path

#: seconds a rank may take to start or to finish a job
TIMEOUT_S = 300.0


def _resolve(spec: str):
    mod, _, attr = spec.partition(":")
    return getattr(importlib.import_module(mod), attr)


def _violations() -> int:
    """A rank's SHARDGUARD violation count (a job)."""
    from ..analysis.shardguard import SHARDGUARD

    return len(SHARDGUARD.violations())


def _serve(rank: int, world: int, store: str, conn, device: str,
           shardguard: bool) -> None:
    # one CPU thread a rank: its float reductions do not depend on the
    # machine, and the ranks do not crowd each other's cores
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    from ..analysis.shardguard import SHARDGUARD
    from ..parallel.mesh import initialize_multihost, shutdown_multihost

    if shardguard:
        SHARDGUARD.enable()
    try:
        initialize_multihost(f"file://{store}", world, rank, backend="gloo",
                             timeout_s=TIMEOUT_S)
        conn.send(("ready", rank))
    except Exception:       # the rank's boundary: reported to the parent
        conn.send(("err", traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                return
            if msg is None:
                return
            spec, args, kwargs = msg
            try:
                conn.send(("ok", _resolve(spec)(*args, **kwargs)))
            except Exception:   # the job's boundary: reported
                conn.send(("err", f"rank {rank}:\n{traceback.format_exc()}"))
    finally:
        shutdown_multihost()


class RankPool:
    """``world`` gloo ranks on ``device`` serving jobs (module docstring)."""

    def __init__(self, world: int, device: str = "cuda",
                 shardguard: bool = False):
        self.world, self.device = world, str(device)
        self.shardguard = shardguard
        self.procs: list = []
        self.conns: list = []
        self._dir: str | None = None

    def _start(self) -> None:
        self._dir = tempfile.mkdtemp(prefix="dl4j_ranks_")
        ctx = multiprocessing.get_context("spawn")
        for r in range(self.world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve, args=(
                r, self.world, str(Path(self._dir) / "store"), child,
                self.device, self.shardguard), daemon=True)
            p.start()
            self.procs.append(p)
            self.conns.append(parent)
        self._collect(TIMEOUT_S, "start")

    def _collect(self, timeout: float, what: str) -> list:
        deadline = time.monotonic() + timeout
        out, errors = [], []
        for r, c in enumerate(self.conns):
            if not c.poll(max(0.0, deadline - time.monotonic())):
                self.close()
                raise TimeoutError(f"rank {r} did not finish {what} within "
                                   f"{timeout} s; the pool is killed")
            try:
                kind, value = c.recv()
            except EOFError:
                kind, value = "err", f"rank {r} died during {what}"
            (errors if kind == "err" else out).append(value)
        if errors:
            self.close()
            raise RuntimeError(f"{what} failed:\n" + "\n".join(errors))
        return out

    def run(self, spec: str, *args, **kwargs) -> list:
        """Every rank's result of ``spec(*args, **kwargs)``, rank order."""
        if not self.procs:
            self._start()
        for c in self.conns:
            c.send((spec, args, kwargs))
        return self._collect(TIMEOUT_S, spec)

    def shardguard_violations(self) -> int:
        """SHARDGUARD violations summed over the ranks (0 before a job)."""
        if not self.procs:
            return 0
        return sum(self.run(f"{__name__}:_violations"))

    def close(self) -> None:
        for c in self.conns:
            try:
                c.send(None)
            except (OSError, BrokenPipeError):
                pass
        for p in self.procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        self.procs, self.conns = [], []
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
