"""Rank processes for the port's multi-rank CPU tests, and the jobs they run.

:class:`RankPool` spawns ``world`` processes that join one gloo process
group through the port's ``initialize_multihost`` (a ``file://``
rendezvous in the pool's own directory, so concurrent test workers never
share a port or a store) and then serve jobs: :meth:`RankPool.run` sends
a job's name and arguments to every rank (SPMD: each runs the same call)
and returns the ranks' results, in rank order.  A job that fails on any
rank, or a pool that does not answer within the job's timeout, fails the
test and the pool is torn down (its processes killed) and started anew
on the next job.  Each rank runs with one CPU thread, so its float
results do not depend on the machine.

The jobs import the port only (no JAX): the tests hold their results
against the JAX package in the test process.  The fixtures follow the
reference's tests: ``tests/test_zero.py`` (D=6, ragged batch sizes) and
``tests/test_elastic_reshard.py`` (D=16, batch 32); the model-parallel
jobs (``mp_*``, ``ep_*``) take the reference's transformer and embedding
fixtures from the test as numpy arrays.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np

# ------------------------------------------------------------------ the pool


def _serve(rank: int, world: int, store: str, conn) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch

    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel.mesh import initialize_multihost

    try:
        initialize_multihost(f"file://{store}", world, rank, backend="gloo",
                             timeout_s=60)
        conn.send(("ready", rank))
    except Exception:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        if msg is None:
            return
        name, args, kwargs = msg
        try:
            _fresh()
            conn.send(("ok", JOBS[name](*args, **kwargs)))
        except Exception:       # the server loop's boundary: reported
            conn.send(("err", f"rank {rank}:\n{traceback.format_exc()}"))


class RankPool:
    """``world`` gloo CPU ranks serving jobs; see the module docstring."""

    def __init__(self, world: int, root, start_timeout: float = 90.0):
        self.world, self.root = world, Path(root)
        self.start_timeout = start_timeout
        self._n = 0
        self.procs: list = []
        self.conns: list = []

    def _start(self) -> None:
        self._n += 1
        d = self.root / f"pool{self._n}"
        d.mkdir(parents=True, exist_ok=True)
        ctx = mp.get_context("spawn")
        for r in range(self.world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve,
                            args=(r, self.world, str(d / "store"), child),
                            daemon=True)
            p.start()
            self.procs.append(p)
            self.conns.append(parent)
        self._collect(self.start_timeout, "start")

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
            if kind == "err":
                errors.append(value)
            out.append(value)
        if errors:
            self.close()
            raise AssertionError(f"{what} failed:\n" + "\n".join(errors))
        return out

    def run(self, name: str, *args, timeout: float = 60.0, **kwargs) -> list:
        """Every rank's result of ``JOBS[name](*args, **kwargs)``."""
        if not self.procs:
            self._start()
        for c in self.conns:
            c.send((name, args, kwargs))
        return self._collect(timeout, name)

    def close(self) -> None:
        for c in self.conns:
            try:
                c.send(None)
            except (OSError, BrokenPipeError):
                pass
        for p in self.procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        self.procs, self.conns = [], []


def _fresh() -> None:
    """Each job starts with clean process-wide registries."""
    from deeplearning4j_tpu_torch.observability import METRICS
    from deeplearning4j_tpu_torch.resilience.faults import FAULTS

    METRICS.reset()
    FAULTS.disarm()


# ------------------------------------------------------------------ fixtures

D = 6
SIZES = [32, 31, 17, 9, 23, 13, 32, 5, 29, 11]
ELASTIC_D = 16
ELASTIC_BATCH = 32


def np_params(d: int = D) -> dict:
    rng = np.random.default_rng(42)
    return {"w": rng.normal(size=(d, 1)).astype(np.float32),
            "b": np.zeros((1,), np.float32)}


def np_data(n: int = 10, seed: int = 0, d: int = D,
            uniform: bool = False) -> list:
    """The ragged batches of the reference's ZeRO tests (``uniform``: every
    batch 32 rows, for runs whose per-rank rows must not depend on where
    a trainer's bucket ladder starts)."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(s, d)).astype(np.float32),
             rng.normal(size=(s, 1)).astype(np.float32))
            for s in ([32] * n if uniform else SIZES[:n])]


def elastic_params() -> dict:
    return {"w": np.zeros((ELASTIC_D, 1), np.float32)}


def elastic_data(n_batches: int = 8, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(ELASTIC_D, 1)).astype(np.float32)
    xs = rng.normal(size=(n_batches * ELASTIC_BATCH, ELASTIC_D)).astype(
        np.float32)
    ys = (xs @ w_true).astype(np.float32)
    b = ELASTIC_BATCH
    return [(xs[i * b:(i + 1) * b], ys[i * b:(i + 1) * b])
            for i in range(n_batches)]


def linear_loss(p, x, y, gen=None):
    return ((x @ p["w"] + p["b"] - y) ** 2).mean()


def elastic_loss(p, x, y, gen=None):
    return ((x @ p["w"] - y) ** 2).mean()


def transform(name: str):
    from deeplearning4j_tpu_torch.optimize import transforms as T

    return {"adam": lambda: T.adam(1e-2),
            "momentum": lambda: T.chain(T.momentum(0.9), T.sgd_lr(5e-2)),
            "adam3": lambda: T.adam(1e-3)}[name]()


def mesh_of(n: int):
    from deeplearning4j_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                        rank_devices)

    return make_mesh(MeshSpec(dp=n), devices=rank_devices()[:n])


def _np_tree(tree):
    import torch

    from deeplearning4j_tpu_torch.utils.tree_math import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy()
                    if torch.is_tensor(t) else t, tree)


def trainer(n_dp: int, stage: int = 0, tx: str = "adam",
            router: str = "iterative_reduce", average_every: int = 8,
            loss=linear_loss):
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer

    return DataParallelTrainer(loss, transform(tx), mesh=mesh_of(n_dp),
                               router=router, average_every=average_every,
                               zero_stage=stage, device="cpu")


# ------------------------------------------------------------------ jobs

def job_train(n_dp, stage=0, tx="adam", steps=8, router="iterative_reduce",
              average_every=8, fit=False, resolve_every=3, uniform=False):
    """Steps (or a ``fit``) over the ZeRO fixture; the losses and final
    params on each member (None off the mesh)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    tr = trainer(n_dp, stage, tx, router, average_every)
    state = tr.init_state(np_params())
    data = np_data(steps, uniform=uniform)
    if fit:
        state, losses = tr.fit(state, [DataSet(x, y) for x, y in data],
                               resolve_every=resolve_every)
    else:
        losses = []
        for x, y in data:
            state, lazy = tr.step(state, x, y)
            losses.append(float(lazy))
    final = _np_tree(tr.final_params(state))
    if not tr.member:
        return None
    return {"losses": losses, "params": final, "step": state.step,
            "tstate_shapes": [tuple(t.shape) for t in
                              _leaves(state.tstate)],
            "params_shapes": [tuple(t.shape) for t in _leaves(state.params)]}


def _leaves(tree):
    import torch

    from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves

    return [t for t in tree_leaves(tree) if torch.is_tensor(t)]


def job_collectives(n):
    """Every collective over an ``n``-rank mesh on rank-dependent inputs
    (``x = arange(24).reshape(4, 6) * (r + 1) + r``)."""
    import torch

    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel.mesh import DP

    mesh = mesh_of(n)
    if not mesh.member:
        return None
    r = mesh.axis_index(DP)
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (r + 1) + r
    with mesh:
        out = {
            "psum": C.psum(x, DP), "pmean": C.pmean(x, DP),
            "all_gather": C.all_gather(x, DP),
            "all_gather_tiled": C.all_gather(x, DP, tiled=True),
            "reduce_scatter": C.reduce_scatter(x.reshape(-1)[:4 * n], DP),
            "reduce_scatter_dim1": C.reduce_scatter(
                torch.arange(3 * 4 * n, dtype=torch.float32).reshape(
                    3, 4 * n) * (r + 1), DP, scatter_dimension=1),
            "rs_or_psum": C.reduce_scatter_or_psum(x.reshape(-1)[:4 * n],
                                                   DP, n),
            "ag_or_identity": C.all_gather_or_identity(x[0], DP, n),
            "ppermute": C.ppermute(x, DP, [(i, (i + 1) % n)
                                           for i in range(n)]),
            "ppermute_partial": C.ppermute(x, DP, [(0, n - 1)]),
            "ring_shift": C.ring_shift(x, DP, n, shift=-1),
            "axis_index": torch.tensor(C.axis_index(DP)),
            "barrier_sum": C.barrier_sum(DP),
        }
    return {k: v.numpy() for k, v in out.items()}


def job_layout(n):
    """``ZeroLayout`` arithmetic at width ``n``: padded and chunk sizes, a
    flatten round trip, this rank's chunks, a gather back to natural."""
    import torch

    from deeplearning4j_tpu_torch.parallel.mesh import DP
    from deeplearning4j_tpu_torch.parallel.zero import ZeroLayout
    from deeplearning4j_tpu_torch.utils.tree_math import tree_map

    mesh = mesh_of(n)
    if not mesh.member:
        return None
    p = tree_map(torch.as_tensor, np_params())
    z = ZeroLayout(mesh, transform("momentum"), p)
    flat = z.flatten_tree(p)
    back = z.unflatten_like(flat, z.natural_params)
    mine = z.chunk_tree(flat, mesh.axis_index(DP), z.natural_params)
    gathered = z.to_natural_host(mine, z.natural_params)
    placed = z.place_flat(p, z.flat_sharding)
    return {"padded": [z.padded_size(s) for s in (1, n, n + 1, 9)],
            "chunk": [z.chunk_size(s) for s in (1, n, n + 1, 9)],
            "roundtrip": all(torch.equal(back[k], p[k]) for k in p),
            "chunks": _np_tree(mine), "placed": _np_tree(placed),
            "gathered": _np_tree(gathered),
            "state_specs": [repr(s.spec) for s in _leaves_of_shardings(
                z.state_shardings)],
            "decay_mask": z.decay_mask}


def _leaves_of_shardings(tree):
    from deeplearning4j_tpu_torch.utils.tree_math import tree_leaves

    return tree_leaves(tree)


def job_state_bytes(n_dp, d=64):
    """The per-rank ``train.*_bytes.device.<rank>`` gauges at stage 0 and
    stage 2 (adam, a ``d``-wide model)."""
    from deeplearning4j_tpu_torch.observability import METRICS

    out = {}
    for stage in (0, 2):
        METRICS.reset()
        tr = trainer(n_dp, stage, "adam")
        tr.init_state(np_params(d))
        g = METRICS.snapshot()["gauges"]
        out[stage] = {k: v for k, v in g.items()
                      if k.startswith(("train.opt_state_bytes.device.",
                                       "train.params_bytes.device."))}
        out["n_dp"] = tr.n_dp
    return out


def job_ckpt_save(root, n_dp, stage, split=3, layout="natural", tx="adam",
                  router="iterative_reduce", average_every=2, uniform=False):
    """Train ``split`` steps at (``n_dp``, ``stage``), checkpoint into
    ``root``."""
    from deeplearning4j_tpu_torch.parallel import CheckpointManager

    mgr = CheckpointManager(root, keep=2)
    tr = trainer(n_dp, stage, tx, router, average_every)
    state = tr.init_state(np_params())
    for x, y in np_data(split, uniform=uniform):
        state, _ = tr.step(state, x, y)
    tr.checkpoint(state, mgr, layout=layout)
    return state.step


def job_ckpt_continue(root, n_dp, stage, split=3, steps=6, reshard=True,
                      tx="adam", router="iterative_reduce", average_every=2,
                      uniform=False):
    """Restore ``root``'s newest checkpoint at (``n_dp``, ``stage``) and
    take the remaining steps; the losses (or the error's class name)."""
    from deeplearning4j_tpu_torch.parallel import CheckpointManager

    mgr = CheckpointManager(root, keep=2)
    tr = trainer(n_dp, stage, tx, router, average_every)
    state = tr.init_state(np_params())
    try:
        state = tr.restore(state, mgr, reshard=reshard)
    except Exception as e:
        return type(e).__name__
    start = state.step
    losses = []
    for x, y in np_data(steps, uniform=uniform)[start:]:
        state, lazy = tr.step(state, x, y)
        losses.append(float(lazy))
    return {"start": start, "losses": losses} if tr.member else None


class _Batch:
    def __init__(self, x, y):
        self.features, self.labels = x, y


def job_elastic(root, faults=(), stage=1, checkpoint_every=2, factory=True,
                n_batches=8):
    """``TrainingSupervisor.fit`` over a trainer factory on every rank of
    the world (the reference's elastic fixture), with ``faults`` = ``[(site,
    at_step, kind)]``; plus the un-faulted fit of ``factory(None)``."""
    from deeplearning4j_tpu_torch.observability import FLIGHTREC, METRICS
    from deeplearning4j_tpu_torch.parallel import (CheckpointManager,
                                                   DataParallelTrainer,
                                                   elastic_mesh)
    from deeplearning4j_tpu_torch.parallel.mesh import rank_devices, world_rank
    from deeplearning4j_tpu_torch.resilience import (FaultSpec, RetryPolicy,
                                                     TrainingSupervisor,
                                                     inject_faults)

    data = [_Batch(x, y) for x, y in elastic_data(n_batches)]

    def make(devices):
        devs = devices if devices is not None else rank_devices()
        return DataParallelTrainer(elastic_loss, transform("adam3"),
                                   mesh=elastic_mesh(devs), zero_stage=stage,
                                   device="cpu")

    ref = make(None)
    _, ref_losses = ref.fit(ref.init_state(elastic_params()), data)
    root = Path(root)
    mgr = CheckpointManager(root / "ckpt", keep=10)
    sup = TrainingSupervisor(mgr, RetryPolicy(max_attempts=6,
                                              backoff_base_s=0.01),
                             install_signal_handlers=False)
    FLIGHTREC.dump_dir = root / f"rec{world_rank()}"
    METRICS.reset()
    specs = [FaultSpec(site, at_step=at, kind=kind)
             for site, at, kind in faults]
    try:
        with inject_faults(*specs, seed=0):
            state, _ = sup.fit(make if factory else make(None),
                               elastic_params(), data, epochs=1,
                               checkpoint_every=checkpoint_every)
    except Exception as e:
        return {"error": type(e).__name__, "message": str(e)}
    snap = METRICS.snapshot()
    return {"step": int(state.step), "ref_losses": ref_losses,
            "losses_by_step": dict(sup.report.losses_by_step),
            "mesh_sizes": list(sup.report.mesh_sizes),
            "resizes": sup.report.resizes,
            "mesh_size": int(sup.trainer.mesh.devices.size),
            "member": sup.trainer.member,
            "bundles": len(list(FLIGHTREC.dump_dir.glob(
                "flightrec-mesh_resize-*"))),
            "counters": {k: v for k, v in snap["counters"].items()
                         if k.startswith(("elastic.", "resilience.",
                                          "checkpoint.reshards"))},
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if k.startswith("elastic.")}}


def job_lm(n_dp, params, batches, tx="momentum", zero1=False, cfg_kw=None,
           finetune_labels=None):
    """``TransformerLM(cfg, mesh)`` train (or classifier fine-tune) steps
    from the shared numpy ``params`` over the global ``batches``; the
    losses and final params on each member."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.models.convert import params_from_numpy
    from deeplearning4j_tpu_torch.optimize import transforms as T

    mesh = mesh_of(n_dp)
    cfg = ttr.TransformerConfig(dtype=torch.float32, **(cfg_kw or {}))
    model = ttr.TransformerLM(cfg, mesh, device="cpu")
    tree = params_from_numpy(params, "cpu")
    t = {"momentum": None, "adam": T.adam(1e-2)}[tx]
    if finetune_labels is not None:
        step = model.build_finetune_step(t, zero1=zero1)
    else:
        step = model.build_train_step(t, zero1=zero1)
    t = t if t is not None else model._default_tx(1e-3 if finetune_labels
                                                  is None else 2e-5)
    opt = (model.init_opt_zero1(tree, t) if zero1
           else model.init_opt(tree, t))
    losses = []
    for toks, tg in batches:
        tree, opt, loss = step(tree, opt, torch.as_tensor(toks),
                               torch.as_tensor(tg))
        losses.append(loss.item())
    if not mesh.member:
        return None
    return {"losses": losses, "params": _np_tree(tree), "count": opt[0],
            "state_shapes": [tuple(s.shape) for s in _leaves(opt[1])]}


def job_prefetch(n_dp, size=2):
    """``prefetch_to_device(sharding=P('dp'))``: this rank's rows."""
    from deeplearning4j_tpu_torch.datasets import prefetch_to_device
    from deeplearning4j_tpu_torch.parallel.mesh import batch_sharding

    mesh = mesh_of(n_dp)
    batches = [(np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + 100 * i,
                np.arange(8) + 10 * i, i) for i in range(3)]
    out = list(prefetch_to_device(iter(batches), size=size, device="cpu",
                                  sharding=batch_sharding(mesh)))
    return [(a.numpy(), b.numpy(), n) for a, b, n in out]


def job_mesh_helpers():
    """Shrink the world's mesh by its last two ranks, grow it back (twice:
    idempotent), and run a barrier over the small mesh's members."""
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel.mesh import (DP, elastic_mesh,
                                                        grow_mesh,
                                                        rank_devices,
                                                        shrink_mesh)

    devs = rank_devices()
    mesh = elastic_mesh(devs)
    small = shrink_mesh(mesh, devs[-2:])
    back = grow_mesh(small, devs[-2:])
    again = grow_mesh(back, devs[-2:])
    psum_small = None
    if small.member:
        with small:
            psum_small = float(C.barrier_sum(DP))
    try:
        elastic_mesh([])
        empty = None
    except ValueError:
        empty = "ValueError"
    return {"sizes": [int(m.devices.size) for m in (mesh, small, back,
                                                      again)],
            "survivors": [d.id for d in small.devices.flat],
            "member_of_small": small.member, "psum_small": psum_small,
            "empty": empty}


# ------------------------------------------------------------- model parallel

TXS = {
    "adamw_cosine": lambda T: T.adamw(T.warmup_cosine(0.1, 0, 100),
                                      weight_decay=0.01),
    "adamw": lambda T: T.adamw(0.01),
    "momentum": lambda T: T.chain(T.momentum(0.9), T.sgd_lr(1e-2)),
    "sgd": lambda T: T.sgd_lr(1e-2),
}


def mp_mesh(spec: dict):
    """The world's first ranks as a mesh of ``spec`` ({axis: size})."""
    from deeplearning4j_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                        rank_devices)

    n = int(np.prod(list(spec.values())))
    return make_mesh(MeshSpec(**spec), devices=rank_devices()[:n])


def mp_model(spec, cfg_kw, n_micro=0):
    import torch

    from deeplearning4j_tpu_torch.models import transformer as ttr

    cfg = ttr.TransformerConfig(dtype=torch.float32, **cfg_kw)
    mesh = mp_mesh(spec) if spec is not None else None
    if n_micro:
        from deeplearning4j_tpu_torch.models.pipeline import \
            PipelinedTransformerLM
        return PipelinedTransformerLM(cfg, mesh, n_micro=n_micro,
                                      device="cpu")
    return ttr.TransformerLM(cfg, mesh, device="cpu")


def job_mp_train(spec, params, batches, cfg_kw, tx="momentum", zero1=False,
                 finetune=False, n_micro=0, ckpt=None, resume=None):
    """Steps of ``TransformerLM`` (``n_micro``: ``PipelinedTransformerLM``)
    over the mesh ``spec`` from the GLOBAL numpy ``params`` on the global
    ``batches`` (``finetune``: classifier steps on (tokens, labels)).
    Returns the losses, the global params gathered back, the step count
    and this rank's state shapes; ``ckpt``: after the steps, the params
    and the optimizer state are gathered and written there by the first
    rank; ``resume``: restore from there first (the checkpoint test)."""
    import torch

    from deeplearning4j_tpu_torch.models.convert import params_from_numpy
    from deeplearning4j_tpu_torch.optimize import transforms as T
    from deeplearning4j_tpu_torch.parallel import CheckpointManager
    from deeplearning4j_tpu_torch.parallel.checkpoint import save_sharded

    model = mp_model(spec, cfg_kw, n_micro)
    specs = model.finetune_specs() if finetune else model._specs()
    tree = model.place(params_from_numpy(params, "cpu"), specs)
    t = TXS[tx](T)
    step = (model.build_finetune_step(t) if finetune
            else model.build_train_step(t, zero1=zero1))
    opt = model.init_opt_zero1(tree, t) if zero1 else model.init_opt(tree, t)
    ospecs = (model.opt_specs_zero1(t, specs) if zero1
              else model.opt_specs(t, specs))
    if resume is not None:
        from deeplearning4j_tpu_torch.parallel.checkpoint import \
            restore_sharded

        tree, opt = restore_sharded(CheckpointManager(resume), model, tree,
                                    opt, specs, ospecs)
    losses = []
    for a, b in batches:
        tree, opt, loss = step(tree, opt, torch.as_tensor(a),
                               torch.as_tensor(b))
        losses.append(loss.item())
    if ckpt is not None:
        save_sharded(CheckpointManager(ckpt, keep=2), model, opt[0], tree,
                     opt, specs, ospecs)
    shapes = [tuple(x.shape) for x in _leaves(opt[1])]
    whole = model.gather(tree, specs)
    if not model.mesh.member:
        return None
    return {"losses": losses, "params": _np_tree(whole), "count": opt[0],
            "state_shapes": shapes}


def job_mp_collectives(spec):
    """psum/pmean/all_gather/ppermute/ring_shift/axis_index over each
    wide axis of ``spec`` on rank-dependent inputs, and the tp pair's and
    ppermute's gradients."""
    import torch

    from deeplearning4j_tpu_torch.parallel import collectives as C

    mesh = mp_mesh(spec)
    if not mesh.member:
        return None
    out = {}
    with mesh:
        for axis, n in spec.items():
            if n == 1:
                continue
            r = C.axis_index(axis)
            x = torch.arange(8, dtype=torch.float32) * (r + 1) + 10 * r
            out[axis] = {
                "psum": C.psum(x, axis), "pmean": C.pmean(x, axis),
                "all_gather": C.all_gather(x, axis),
                "ring_shift": C.ring_shift(x, axis, n, 1),
                "ppermute_back": C.ppermute(x, axis,
                                            [(i, (i - 1) % n)
                                             for i in range(n)]),
                "axis_index": torch.tensor(r)}
            w = x.clone().requires_grad_(True)
            y = C.ppermute(w * w, axis, [(i, (i + 1) % n) for i in range(n)])
            (y * (r + 1)).sum().backward()
            out[axis]["ppermute_grad"] = w.grad
            w = x.clone().requires_grad_(True)
            (C.reduce_from_tp(C.copy_to_tp(w, axis) * (r + 1), axis)
             * x).sum().backward()
            out[axis]["tp_pair_grad"] = w.grad
    return {a: {k: v.detach().numpy() for k, v in d.items()}
            for a, d in out.items()}


def job_ep_embedding(kind, corpus, kw, n_ep=4, similarity=None):
    """``ShardedWord2Vec`` (``kind`` "w2v") or ``ShardedGlove`` over an
    ep mesh: the embeddings (and syn1 for Word2Vec), three nearest words
    of "cat", and with ``similarity=(a, b, c)`` the similarities a-b and
    a-c."""
    from deeplearning4j_tpu_torch.text.sharded_embedding import (
        ShardedGlove, ShardedWord2Vec)

    mesh = mp_mesh({"dp": 1, "ep": n_ep})
    cls = ShardedWord2Vec if kind == "w2v" else ShardedGlove
    m = cls(corpus, mesh=mesh, device="cpu", **kw).fit()
    if not mesh.member:
        return None
    out = {"nearest": m.words_nearest("cat", 3)}
    if similarity is not None:
        a, b, c = similarity
        out["similarity"] = (m.similarity(a, b), m.similarity(a, c))
    if kind == "w2v":
        out["emb"] = m.embeddings
        out["syn1"] = m.syn1.numpy()
    else:
        out["emb"] = m.syn0.numpy()
    return out


def job_pp_forward(spec, params, tokens, cfg_kw, n_micro):
    """``PipelinedTransformerLM.forward`` of the global tokens: the
    global logits, on every member."""
    import torch

    from deeplearning4j_tpu_torch.models.convert import params_from_numpy

    model = mp_model(spec, cfg_kw, n_micro)
    tree = model.place(params_from_numpy(params, "cpu"))
    logits = model.forward(tree, torch.as_tensor(tokens))
    return logits.numpy() if model.mesh.member else None


def job_pp_guards(cfg_kw):
    """The pipeline's refusals at pp=2: n_layers not divisible by pp, and
    the decode entry points on the stacked layout; then the suggested
    path (gather, unstack, a one-device ``sample``) runs."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.models.pipeline import (
        PipelinedTransformerLM, unstack_layers)

    mesh = mp_mesh({"dp": 1, "pp": 2})
    cfg = ttr.TransformerConfig(dtype=torch.float32, **cfg_kw)
    out = {}
    try:
        PipelinedTransformerLM(ttr.TransformerConfig(
            dtype=torch.float32, **dict(cfg_kw, n_layers=3)), mesh,
            device="cpu")
    except ValueError as e:
        out["indivisible"] = str(e)
    model = PipelinedTransformerLM(cfg, mesh, n_micro=2, device="cpu")
    params = model.place(model.init())
    for name in ("sample", "beam_search", "score"):
        try:
            getattr(model, name)(params, [1, 2], 4)
        except NotImplementedError as e:
            out[name] = str(e)
    flat = unstack_layers(model.gather(params), cfg.n_layers)
    out["sampled"] = ttr.TransformerLM(cfg, device="cpu").sample(
        flat, [1, 2], 4, temperature=0.0)
    return out if mesh.member else None


def job_pp_one_device(ckpt, spec, cfg_kw, n_micro, batches, tx="momentum"):
    """A pipelined ZeRO-1 checkpoint restored into a one-device
    ``TransformerLM``: the global params unstacked, the state put back in
    its natural layout, then steps on ``batches``."""
    import torch

    from deeplearning4j_tpu_torch.models import transformer as ttr
    from deeplearning4j_tpu_torch.models.pipeline import (
        unstack_layers, zero1_state_to_natural)
    from deeplearning4j_tpu_torch.optimize import transforms as T
    from deeplearning4j_tpu_torch.parallel import CheckpointManager

    model = mp_model(spec, cfg_kw, n_micro)
    t = TXS[tx](T)
    tmpl = model.init()
    z1, _ = model._z1_template_and_specs(tmpl, model._specs())
    r = CheckpointManager(ckpt).restore(tmpl, (0, t.init(z1)))
    count, st = zero1_state_to_natural(model, t, r["tstate"], r["params"])
    cfg = ttr.TransformerConfig(dtype=torch.float32, **cfg_kw)
    solo = ttr.TransformerLM(cfg, device="cpu")
    tree = unstack_layers(r["params"], cfg.n_layers)
    st = _unstack_state(st, cfg.n_layers)
    step = solo.build_train_step(t)
    opt, losses = (count, st), []
    for a, b in batches:
        tree, opt, loss = step(tree, opt, torch.as_tensor(a),
                               torch.as_tensor(b))
        losses.append(loss.item())
    return {"losses": losses, "params": _np_tree(tree), "count": opt[0]}


def _unstack_state(st, n_layers):
    """Unstack every params-shaped subtree (a dict with ``layers``) of an
    optimizer state."""
    from deeplearning4j_tpu_torch.models.pipeline import unstack_layers

    if isinstance(st, dict):
        if "layers" in st and isinstance(st["layers"], dict):
            return unstack_layers(st, n_layers)
        return {k: _unstack_state(v, n_layers) for k, v in st.items()}
    if isinstance(st, (list, tuple)):
        return type(st)(_unstack_state(v, n_layers) for v in st)
    return st


JOBS = {name.removeprefix("job_"): fn for name, fn in dict(globals()).items()
        if name.startswith("job_")}
