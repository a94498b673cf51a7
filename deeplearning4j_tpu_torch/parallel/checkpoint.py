"""Checkpoint / resume with integrity verification.

Port of ``deeplearning4j_tpu/parallel/checkpoint.py``, in the same format,
so each package restores the other's checkpoints.  A checkpoint carries
params + optimizer (transform) state + step counter + RNG key + data
cursor, with keep-last-N rotation and atomic writes.  Storage is a
directory of npz payloads + JSON metadata, host-side: tensors are copied
to the host before the write, and a restore places each leaf on its
template leaf's device.

The format, which both packages share:

- ``params.npz`` / ``tstate.npz``: one array per tree leaf, keyed by the
  leaf's path as JAX's ``tree_flatten_with_path`` renders it and joins
  with ``/`` — ``['layers']/[0]/['b1']`` for a parameter,
  ``[0]`` and ``[1]/[0]/['layers']/...`` for the ``(count, tx_state)``
  optimizer state.  Dicts, lists and tuples are the tree's nodes (dict
  keys in sorted order), None is an empty subtree, and everything else is
  a leaf.  A bfloat16 leaf is written as 2-byte void (``|V2``), as numpy
  stores the reference's ml_dtypes bfloat16, and read back as bfloat16.
- ``key.npy``: the RNG key as ``uint32[2]`` (the reference's raw threefry
  key data; the port derives its ``torch.Generator`` seeds from the same
  two words, so the two packages read each other's keys but do not draw
  the same streams from them).
- ``meta.json``, written last: step, data cursor, ``has_tstate``,
  ``has_key``, ``extra``, the topology stamp (``dp`` width, zero stage,
  leaf layout) and the per-file SHA-256 manifest.

Integrity: every payload file's SHA-256 lands in ``meta.json`` at save
time; ``verify()`` recomputes them, and a restore with no explicit step
walks BACK from the newest checkpoint to the newest one that verifies — a
truncated or bit-flipped checkpoint is detected and skipped
(``checkpoint.corrupt_detected``), never silently loaded.  The
``checkpoint.write`` fault site corrupts the payload *after* the checksums
are recorded, so the whole detection path is testable in-process.

Publish is race-free against concurrent readers: every step dir
materializes inside a unique temp dir (payloads fsync'd, ``meta.json``
last) and appears under its ``ckpt_*`` name only through one atomic
``os.replace``, so ``all_steps()``/``latest_valid_step()`` polled from a
serving process never list a partially written step.

Several ranks: the trainer gathers what its ranks hold (collective over
its mesh), then :func:`publish_from_first_rank` has the mesh's first rank
write while the others wait at a barrier that also carries whether the
write succeeded, so a failed write fails every rank alike; every rank
then restores from the same files and keeps its own part.  A model split
over tp, pp or sp (and its ZeRO-1 state) goes the same way through
:func:`save_sharded` / :func:`restore_sharded`: its blocks are gathered
into the reference's GLOBAL layout (what ``jax.device_get`` of the
reference's placed trees gives), so the files restore at another mesh,
at one device and in the JAX package.  Same-step
republish and rotation move the old dir aside (atomic rename to a
non-``ckpt_`` name) before deleting it.  ``quarantine(step)`` renames a
published-but-bad step out of the ``ckpt_*`` namespace.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..observability import FLIGHTREC, METRICS, trace
from ..resilience.faults import FAULTS, corrupt_file
from .mesh import DP, MeshMismatchError
from .zero import flat_padded_size, host_flat_to_natural


class CheckpointCorruptError(RuntimeError):
    """An explicitly-requested checkpoint failed checksum verification."""

    def __init__(self, step: int, directory):
        super().__init__(
            f"checkpoint step {step} under {directory} failed checksum "
            "verification — refusing to restore corrupt state")
        self.step = step


def _fsync_path(path: Path) -> None:
    """fsync a file (or a directory's entry table) — the durability half
    of the unique-tempfile + fsync + ``os.replace`` publish idiom.  Best
    effort on platforms whose filesystems refuse directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _walk(tree, path=()):
    """``(path, leaf)`` pairs in JAX's flatten order: dict keys sorted,
    None an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _walk(x, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


def _rebuild(tree, leaves, path=()):
    """``tree`` with each leaf replaced by ``leaves[path key]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (f"[{k!r}]",))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves, path + (f"[{i}]",))
                          for i, x in enumerate(tree))
    return leaves["/".join(path)]


def _to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array the file holds (bfloat16 as ``|V2``)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A file's array as a tensor on ``device``; 2-byte non-numeric arrays
    (``|V2``, ml_dtypes bfloat16) are bfloat16 bits."""
    if arr.dtype.itemsize == 2 and arr.dtype.kind not in "iuf":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _flatten_with_paths(tree) -> dict[str, np.ndarray]:
    return {key: _to_host(leaf) for key, leaf in _walk(tree)}


def _sha256(path: Path) -> str:
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()


def _sha256_all(paths) -> list[str]:
    """The files' SHA-256 digests, one thread a file: hashing releases the
    GIL, and a full-width save is ~1.3 GB over two files."""
    paths = list(paths)
    if len(paths) < 2:
        return [_sha256(p) for p in paths]
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        return list(pool.map(_sha256, paths))


@dataclasses.dataclass
class _ReshardCtx:
    """What the restore knows about the widths on either side of the seam.

    ``saved_dp``/``zero_stage`` come from the checkpoint metadata,
    ``restore_dp`` from the caller; ``reshard`` authorizes host-side
    re-splits.  ``transformed`` records whether any leaf actually needed
    one (drives the reshard metrics/chaos accounting).
    """

    saved_dp: int | None = None
    restore_dp: int | None = None
    zero_stage: int | None = None
    reshard: bool = False
    transformed: int = 0


def _fit_leaf(key: str, arr: np.ndarray, leaf, ctx: _ReshardCtx | None):
    """Shape-guard one array leaf against its template.  Mismatches that
    flat-pad arithmetic explains are re-split exactly when ``reshard``
    allows; everything else raises a named error here, never a raw
    reshape error downstream."""
    want = getattr(leaf, "shape", None)
    if want is None or tuple(arr.shape) == tuple(want):
        return arr
    if ctx is not None and ctx.saved_dp and arr.ndim == 1 \
            and arr.shape[0] == flat_padded_size(_size_of(want), ctx.saved_dp):
        # a flat padded P('dp') leaf from the save-side width.  Same-width
        # flat->natural is layout normalization and always allowed; a
        # CROSS-width re-split is a reshard and needs the flag.
        cross = ctx.restore_dp is not None and ctx.restore_dp != ctx.saved_dp
        if cross and not ctx.reshard:
            raise MeshMismatchError(ctx.saved_dp, ctx.restore_dp,
                                    ctx.zero_stage, detail=f"flat leaf {key}")
        ctx.transformed += 1
        return host_flat_to_natural(arr, tuple(want), ctx.saved_dp)
    saved_dp = ctx.saved_dp if ctx is not None else None
    restore_dp = ctx.restore_dp if ctx is not None else None
    stage = ctx.zero_stage if ctx is not None else None
    raise MeshMismatchError(
        saved_dp, restore_dp, stage,
        detail=f"leaf {key} has shape {tuple(arr.shape)}, template wants "
               f"{tuple(want)} and no flat-pad width explains it")


def _size_of(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _restore_like(template, arrays: dict[str, np.ndarray],
                  ctx: _ReshardCtx | None = None):
    """``template``'s tree with every leaf read from ``arrays``: a tensor
    leaf becomes a tensor on the template leaf's device (a ``meta``
    template, which has shapes only, on the CPU) with the file's dtype; a
    numpy leaf an array; a Python scalar leaf a scalar of its type (so a
    count saved as a 0-d int32 array restores into an ``int``)."""
    leaves = {}
    for key, leaf in _walk(template):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if torch.is_tensor(leaf):
            dev = leaf.device if leaf.device.type != "meta" else "cpu"
            leaves[key] = _to_tensor(_fit_leaf(key, arr, leaf, ctx), dev)
        elif isinstance(leaf, np.ndarray):
            leaves[key] = np.asarray(_fit_leaf(key, arr, leaf, ctx))
        elif isinstance(leaf, (bool, np.bool_)):
            leaves[key] = bool(arr.item())
        else:
            leaves[key] = type(leaf)(arr.item())
    unused = sorted(set(arrays) - set(leaves))
    if unused:
        # template drift: the checkpoint carries leaves this template does
        # not — restoring would silently drop state, so say so loudly
        warnings.warn(
            f"checkpoint contains {len(unused)} key(s) absent from the "
            f"restore template (ignored): {unused[:5]}", stacklevel=3)
        METRICS.increment("checkpoint.unused_keys", len(unused))
    return _rebuild(template, leaves)


class CheckpointManager:
    """Keep-last-N rotating checkpoints under a directory.

    ``read_only=True`` is the serving-side open path: verify / restore /
    ``latest_valid_step`` only — the directory is never created (a typo'd
    path fails loudly instead of serving from an empty dir) and ``save``
    raises, so an inference process can never clobber the trainer's
    rotation.
    """

    def __init__(self, directory: str | Path, keep: int = 3,
                 read_only: bool = False):
        self.directory = Path(directory)
        self.read_only = read_only
        if read_only:
            if not self.directory.is_dir():
                raise FileNotFoundError(
                    f"checkpoint directory {self.directory} does not exist "
                    "(read-only manager refuses to create it)")
        else:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    @classmethod
    def open_read_only(cls, directory: str | Path) -> "CheckpointManager":
        """Open an EXISTING checkpoint directory for restore-only use."""
        return cls(directory, read_only=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, tstate=None, key=None,
             data_cursor: int = 0, extra: dict | None = None,
             dp_width: int | None = None, zero_stage: int | None = None,
             layout: str | None = None) -> Path:
        if self.read_only:
            raise RuntimeError(
                "CheckpointManager opened read-only (serving open path): "
                "save() is not allowed")
        with trace.span("checkpoint.save", step=step), \
                METRICS.time("checkpoint.save"):
            # each leaf's copy to the host waits for the work queued on
            # its stream, so the snapshot is of the state as the caller
            # holds it (the trainer also resolves its loss ring first)
            path = self._save(step, params, tstate, key, data_cursor, extra,
                              dp_width=dp_width, zero_stage=zero_stage,
                              layout=layout)
        METRICS.increment("checkpoint.saves")
        return path

    def _save(self, step: int, params, tstate=None, key=None,
              data_cursor: int = 0, extra: dict | None = None,
              dp_width: int | None = None, zero_stage: int | None = None,
              layout: str | None = None) -> Path:
        ckpt_dir = self.directory / f"ckpt_{step:010d}"
        tmp = Path(tempfile.mkdtemp(dir=self.directory))
        try:
            np.savez(tmp / "params.npz", **_flatten_with_paths(params))
            if tstate is not None:
                np.savez(tmp / "tstate.npz", **_flatten_with_paths(tstate))
            if key is not None:
                np.save(tmp / "key.npy", np.asarray(
                    key.cpu() if torch.is_tensor(key) else key, np.uint32))
            payloads = sorted(p for p in tmp.iterdir() if p.is_file())
            for p in payloads:
                _fsync_path(p)
            meta = {
                "step": step,
                "data_cursor": data_cursor,
                "has_tstate": tstate is not None,
                "has_key": key is not None,
                "extra": extra or {},
                # topology stamp: the dp width / zero stage / leaf layout
                # this checkpoint was written under — what the resharding
                # restore (and the MeshMismatchError contract) keys off.
                # ``layout`` is "natural" (gathered, width-agnostic) or
                # "flat" (padded P('dp') vectors of the save-side width).
                "topology": {DP: dp_width, "zero_stage": zero_stage,
                             "layout": layout or "natural"},
                # per-file SHA-256 manifest: verify() recomputes these; a
                # checkpoint whose payloads do not match is never restored
                "checksums": dict(zip((p.name for p in payloads),
                                      _sha256_all(payloads))),
            }
            # meta.json is the publish marker: written LAST, fsync'd, so a
            # dir carrying it carries every payload its checksums name
            (tmp / "meta.json").write_text(json.dumps(meta, indent=2))
            _fsync_path(tmp / "meta.json")
            _fsync_path(tmp)
            # chaos seam: damage the payload AFTER the manifest is written,
            # exactly like a torn write / bad medium under the checksums
            spec = FAULTS.check("checkpoint.write", step)
            if spec is not None:
                corrupt_file(tmp / "params.npz", spec.kind)
            # same-step republish: the old dir moves ASIDE via atomic
            # rename (never an in-place rmtree) — a racing reader sees
            # the complete old tree, a clean miss (verify fails CLOSED on
            # the unreadable path and the walk-back retries), or the
            # complete new tree; never a half-deleted one.  The absent
            # window is bounded by two renames.
            trash = self._trash_path()
            if ckpt_dir.exists():
                os.replace(ckpt_dir, trash)
            os.replace(tmp, ckpt_dir)  # atomic publish
            _fsync_path(self.directory)
            shutil.rmtree(trash, ignore_errors=True)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._rotate()
        return ckpt_dir

    def _trash_path(self) -> Path:
        """A unique non-``ckpt_`` empty dir inside the directory — the
        rename target for dirs on their way out (``os.replace`` of a dir
        onto an empty dir is atomic on POSIX), invisible to
        ``all_steps``."""
        return Path(tempfile.mkdtemp(prefix=".trash-", dir=self.directory))

    def _rotate(self):
        ckpts = self.all_steps()
        for step in ckpts[:-self.keep] if self.keep > 0 else []:
            # rename-then-delete: mid-rmtree a concurrent lister must not
            # find a half-deleted ckpt_* dir (meta present, payloads gone)
            victim = self.directory / f"ckpt_{step:010d}"
            trash = self._trash_path()
            try:
                os.replace(victim, trash)
            except OSError:
                continue  # already gone (another writer rotated it)
            shutil.rmtree(trash, ignore_errors=True)

    # ------------------------------------------------------------------ load
    def all_steps(self) -> list[int]:
        steps = []
        for p in self.directory.glob("ckpt_*"):
            try:
                step = int(p.name.split("_")[1])
            except (IndexError, ValueError):
                continue
            # publish marker: a ckpt_* dir without meta.json is residue
            # from a crashed writer (or a reader racing one pre-atomic
            # publish) — never a listable checkpoint
            if not (p / "meta.json").is_file():
                continue
            steps.append(step)
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------ verify
    def verify(self, step: int) -> bool:
        """Recompute every payload file's SHA-256 against the ``meta.json``
        manifest.  Unreadable/unparseable metadata counts as corrupt;
        pre-checksum checkpoints (no manifest) pass vacuously."""
        ckpt_dir = self.directory / f"ckpt_{step:010d}"
        try:
            meta = json.loads((ckpt_dir / "meta.json").read_text())
        except (OSError, json.JSONDecodeError):
            return False
        checksums = meta.get("checksums")
        if checksums is None:
            return True
        try:
            got = _sha256_all(ckpt_dir / name for name in checksums)
        except OSError:
            return False
        if got != list(checksums.values()):
            return False
        METRICS.increment("checkpoint.verifications")
        return True

    def latest_valid_step(self) -> int | None:
        """Newest step that passes :meth:`verify` (the restore target)."""
        for step in reversed(self.all_steps()):
            if self.verify(step):
                return step
        return None

    # ------------------------------------------------------------ quarantine
    def quarantine(self, step: int) -> Path:
        """Atomically retire a published-but-bad step (the online loop's
        rollback hook): one rename moves ``ckpt_<step>``
        to ``bad_<step>`` — outside the ``ckpt_*`` listing namespace, so
        ``latest_valid_step()`` stops offering it instantly, while the
        evidence (a checkpoint that VERIFIES but regressed serving) stays
        on disk for the flight-recorder bundle to point at.  Returns the
        quarantine path; raises ``FileNotFoundError`` if the step is not
        published."""
        if self.read_only:
            raise RuntimeError(
                "CheckpointManager opened read-only (serving open path): "
                "quarantine() is not allowed")
        src = self.directory / f"ckpt_{step:010d}"
        dst = self.directory / f"bad_{step:010d}"
        if not src.is_dir():
            raise FileNotFoundError(f"no published checkpoint {src}")
        if dst.exists():
            shutil.rmtree(dst, ignore_errors=True)
        os.replace(src, dst)
        _fsync_path(self.directory)
        METRICS.increment("checkpoint.quarantined")
        return dst

    def restore(self, params_template, tstate_template=None,
                step: int | None = None, *, reshard: bool = False,
                dp_width: int | None = None) -> dict:
        """Returns dict(step, params, tstate, key, data_cursor, extra,
        saved_dp, zero_stage, resharded).

        With ``step=None`` walks back from the newest checkpoint to the
        newest one that verifies, skipping (and counting) corrupt ones;
        an explicit ``step`` that fails verification raises
        :class:`CheckpointCorruptError` instead of loading garbage.

        ``dp_width`` declares the mesh width this restore targets.  When it
        differs from the width stamped at save time, ``reshard=True``
        re-splits the state exactly (natural-layout leaves pass through
        width-agnostic; flat padded ``P('dp')`` leaves are sliced back to
        natural host-side, no renormalization) and ``reshard=False`` raises
        :class:`MeshMismatchError` naming both widths — never a raw shape
        error deep in ``zero.py``.
        """
        with trace.span("checkpoint.restore"), \
                METRICS.time("checkpoint.restore"):
            out = self._restore(params_template, tstate_template, step,
                                reshard=reshard, dp_width=dp_width)
        METRICS.increment("checkpoint.restores")
        return out

    def _restore(self, params_template, tstate_template=None,
                 step: int | None = None, *, reshard: bool = False,
                 dp_width: int | None = None) -> dict:
        if step is not None:
            if not self.verify(step):
                METRICS.increment("checkpoint.corrupt_detected")
                FLIGHTREC.dump("checkpoint_corrupt", extra={
                    "step": int(step), "directory": str(self.directory)})
                raise CheckpointCorruptError(step, self.directory)
        else:
            steps = self.all_steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
            for s in reversed(steps):
                if self.verify(s):
                    step = s
                    break
                METRICS.increment("checkpoint.corrupt_detected")
                warnings.warn(
                    f"checkpoint step {s} under {self.directory} failed "
                    "checksum verification — falling back to an older "
                    "checkpoint", stacklevel=4)
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint under {self.directory} passed "
                    "verification (all corrupt)")
        ckpt_dir = self.directory / f"ckpt_{step:010d}"
        meta = json.loads((ckpt_dir / "meta.json").read_text())
        topo = meta.get("topology") or {}
        extra = meta.get("extra") or {}
        saved_dp = topo.get(DP)
        if saved_dp is None:  # pre-topology checkpoints stamped via extra
            saved_dp = extra.get("saved_dp")
        zero_stage = topo.get("zero_stage")
        if zero_stage is None:
            zero_stage = extra.get("zero_stage")
        if (dp_width is not None and saved_dp is not None
                and int(saved_dp) != int(dp_width) and not reshard):
            # the silent failure mode, made loud: cross-width restore with
            # resharding off fails HERE with both widths named, for every
            # zero stage — even when a size coincidence would have let the
            # leaves through.
            raise MeshMismatchError(int(saved_dp), int(dp_width), zero_stage)
        ctx = _ReshardCtx(
            saved_dp=int(saved_dp) if saved_dp is not None else None,
            restore_dp=int(dp_width) if dp_width is not None else None,
            zero_stage=zero_stage, reshard=reshard)
        cross_width = (ctx.saved_dp is not None and ctx.restore_dp is not None
                       and ctx.saved_dp != ctx.restore_dp)
        if cross_width:
            # chaos seam: a reshard that dies mid-flight (preempted host,
            # OOM during the re-split) — transient, retried by the
            # supervisor like any other step fault
            FAULTS.maybe_fire("checkpoint.reshard", step)
        t0 = time.monotonic()
        params_npz = np.load(ckpt_dir / "params.npz")
        params = _restore_like(params_template, dict(params_npz), ctx)
        tstate = None
        if meta["has_tstate"] and tstate_template is not None:
            tstate = _restore_like(
                tstate_template, dict(np.load(ckpt_dir / "tstate.npz")), ctx)
        key = None
        if meta["has_key"]:
            key = np.asarray(np.load(ckpt_dir / "key.npy"), np.uint32)
        resharded = cross_width or ctx.transformed > 0
        if cross_width:
            METRICS.increment("checkpoint.reshards")
            METRICS.gauge("elastic.reshard_seconds", time.monotonic() - t0)
        return {
            "step": meta["step"],
            "params": params,
            "tstate": tstate,
            "key": key,
            "data_cursor": meta["data_cursor"],
            "extra": meta["extra"],
            "saved_dp": ctx.saved_dp,
            "zero_stage": zero_stage,
            "resharded": resharded,
        }


def publish_from_first_rank(manager: CheckpointManager, mesh, step: int,
                            params, **save_kw) -> Path | None:
    """``manager.save(step, params, **save_kw)`` on the first rank of
    ``mesh``; every member then meets the others in one all-reduce of a
    success flag (the barrier), and all raise if the write failed.
    Returns the written directory on the writer, else None; a rank
    outside the mesh does nothing."""
    if not mesh.member:
        return None
    path, err = None, None
    if mesh.rank == mesh.ranks[0]:
        try:
            path = manager.save(step, params, **save_kw)
        except Exception as e:  # re-raised below, after the barrier
            err = e
    if len(mesh.ranks) > 1:
        from . import collectives as clv

        with mesh:
            ok = torch.full((), 0.0 if err is not None else 1.0,
                            device=clv.collective_device())
            # the barrier's verdict: every rank learns whether the write
            # landed (a save is a fence)
            # graftlint: disable=HS01
            total = int(clv.psum(ok, mesh.axis_names).item())
        if err is None and total != len(mesh.ranks):
            raise RuntimeError(f"checkpoint step {step}: the write on rank "
                               f"{mesh.ranks[0]} failed")
    if err is not None:
        raise err
    return path


def _host_tree(tree):
    """``tree`` with every tensor leaf copied to the host."""
    from ..utils.tree_math import tree_map

    return tree_map(lambda x: x.detach().cpu() if torch.is_tensor(x) else x,
                    tree)


def save_sharded(manager: CheckpointManager, model, step: int, params,
                 tstate=None, specs=None, tstate_specs=None,
                 **save_kw) -> Path | None:
    """Checkpoint a model placed over its mesh: ``params`` and ``tstate``
    (this rank's blocks, placed by ``specs`` / ``tstate_specs``; default
    the model's param specs and its optimizer specs of a replicated
    state) are gathered into their global layout (collective over the
    mesh), and the mesh's first rank writes them
    (:func:`publish_from_first_rank`).  Returns the directory on the
    writer, else None."""
    specs = specs if specs is not None else model._specs()
    whole = _host_tree(model.gather(params, specs))
    state = None
    if tstate is not None:
        state = _host_tree(model.gather(tstate, tstate_specs))
    return publish_from_first_rank(manager, model.mesh, step, whole,
                                   tstate=state, **save_kw)


def restore_sharded(manager: CheckpointManager, model, params, tstate=None,
                    specs=None, tstate_specs=None, step: int | None = None):
    """The inverse of :func:`save_sharded`: read the global trees (the
    templates' global shapes follow from this rank's blocks ``params`` /
    ``tstate`` and their specs) and return this rank's blocks of them,
    ``(params, tstate)``, on the model's device."""
    from ..models.transformer import _map_specs
    from .mesh import NamedSharding, global_shape

    specs = specs if specs is not None else model._specs()

    def meta(x, spec):
        if not torch.is_tensor(x):
            return x
        shape = global_shape(tuple(x.shape), NamedSharding(model.mesh, spec))
        return torch.empty(shape, dtype=x.dtype, device="meta")

    r = manager.restore(
        _map_specs(meta, params, specs),
        tstate_template=(None if tstate is None
                         else _map_specs(meta, tstate, tstate_specs)),
        step=step)
    out = model.place(r["params"], specs)
    if tstate is None:
        return out, None
    return out, model.place(r["tstate"], tstate_specs)
