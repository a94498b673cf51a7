"""Runtime placement drift detection: the dynamic half of the SH rules.

Port of ``deeplearning4j_tpu/analysis/shardguard.py``.  A JAX array
carries its sharding; a torch tensor carries a device and a shape, and
the sharding is the caller's convention (``parallel.mesh.NamedSharding``
over the ranks of a mesh, each rank holding its ``local_block``).  So a
leaf's *placement* here is its device plus the local block shape its
``NamedSharding`` implies — the global shape ``global_shape(local,
sharding)`` gives back.  ``ShardGuard.wrap(site, fn, ...)`` returns a
call-compatible wrapper around a step function that, while the guard is
enabled, diffs the placements of the tensors crossing the call boundary:

- **explicit mode** (``in_shardings``/``out_shardings`` given): each
  positional argument's tensor leaves are compared with the declared
  ``NamedSharding``: the leaf must sit on the site's ``device`` (when the
  wrap names one; otherwise the first call's), and the global shape its
  local block implies under the declared spec must be the first call's.
  A leaf arriving on another device, or a block of another width (a
  global batch where this rank's rows were declared, a chunk cut for
  another dp width), is the mismatch.
- **baseline mode** (no expectations): the first enabled call captures
  each leaf's device and shape as the site's baseline; later calls that
  arrive differently placed are flagged as drift — the mode of the ZeRO
  step and the serving decode dispatch, whose placements are emergent.

Contiguity, strides and dtype are representation, not placement, and are
never flagged (the reference says the same of its representation
changes).  Each mismatch is recorded once per (site, direction, leaf) as
a :class:`Violation` and counted per occurrence into the
``shardguard.violations.resharded_input`` / ``.resharded_output``
gauges.  Disabled, the wrapper costs one attribute check per dispatch —
it is always installed, never hot.

Opt-in only: ``DL4J_TPU_SHARDGUARD=1`` in a process's environment
enables it for the whole process (each rank of a run reads its own);
tests use :func:`shardguard_active`.  Only positional arguments are
checked (every wrapped site dispatches positionally); non-tensor leaves
(a generator, an int) are skipped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading

ENV_SHARDGUARD = "DL4J_TPU_SHARDGUARD"

_ON_VALUES = {"1", "on", "true", "yes", "enabled"}


def enabled_from_env() -> bool:
    """True when ``DL4J_TPU_SHARDGUARD`` asks for process-wide guarding."""
    return os.environ.get(ENV_SHARDGUARD, "").strip().lower() in _ON_VALUES


@dataclasses.dataclass(frozen=True)
class Violation:
    """One runtime finding — a dispatch whose placements drifted."""

    kind: str                    # "resharded-input" | "resharded-output"
    site: str                    # wrap() label, e.g. "train.sync_step"
    message: str
    details: tuple = ()          # (leaf path, expected, actual)

    def __str__(self) -> str:    # report/assert readability
        return f"[{self.kind}] {self.site}: {self.message}"


def _leaves_with_paths(tree, path: str = ""):
    """(path string, tensor leaf) pairs over the port's trees (dicts with
    sorted keys, lists, tuples); other leaves are skipped."""
    import torch

    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _leaves_with_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree)
                for pl in _leaves_with_paths(x, f"{path}[{i}]")]
    return [(path, tree)] if torch.is_tensor(tree) else []


def _implied_global(shape, sharding) -> tuple:
    """The global shape a local block of ``shape`` stands for under a
    ``NamedSharding`` (the shape itself without one)."""
    if sharding is None:
        return tuple(shape)
    from ..parallel.mesh import global_shape

    return tuple(global_shape(tuple(shape), sharding))


class ShardGuard:
    """The detector: per-site placement expectations + drift baselines.

    A process-wide singleton (:data:`SHARDGUARD`) so trainer, serving
    engine and tests all feed one findings list; per-wrapper baselines
    live on the wrapper closure, so two trainer instances (or two ZeRO
    stages) never cross-contaminate each other's captured placements.
    """

    def __init__(self) -> None:
        self._meta = threading.Lock()
        self._enabled = False
        self._violations: list[Violation] = []
        self._reported: set[tuple] = set()     # (site, kind, path) dedup
        self._counts = {"resharded-input": 0, "resharded-output": 0}

    # ------------------------------------------------------------- switch
    def enable(self) -> "ShardGuard":
        self._enabled = True
        return self

    def disable(self) -> None:
        self._enabled = False

    # symmetry with lockguard's install/uninstall vocabulary
    install = enable
    uninstall = disable

    @property
    def enabled(self) -> bool:
        return self._enabled

    # --------------------------------------------------------------- wrap
    def wrap(self, site: str, fn, in_shardings=None, out_shardings=None,
             *, device=None):
        """Wrap a step function for dispatch-time placement diffs.

        ``in_shardings``/``out_shardings`` are per-position
        ``NamedSharding`` expectations (``None`` entries skip that
        position); omit both for baseline mode.  ``device`` is where the
        site's tensors must live in explicit mode (a ``NamedSharding``
        over rank devices does not name the rank's CUDA device).  Inputs
        are checked BEFORE the call — a step may update them in place.
        """
        guard = self
        baseline: dict[tuple, tuple] = {}   # (io, path) -> (device, shape)
        want_dev = None if device is None else str(device)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if guard._enabled:
                guard._check(site, "input", args, in_shardings, baseline,
                             want_dev)
            out = fn(*args, **kwargs)
            if guard._enabled:
                outs = out if isinstance(out, tuple) else (out,)
                guard._check(site, "output", outs, out_shardings, baseline,
                             want_dev)
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    # -------------------------------------------------------------- diffs
    def _check(self, site: str, io: str, values: tuple, expected,
               baseline: dict, want_dev: str | None) -> None:
        kind = f"resharded-{io}"
        for pos, value in enumerate(values):
            sh = None
            if expected is not None:
                if pos >= len(expected) or expected[pos] is None:
                    continue
                sh = expected[pos]
            for path, leaf in _leaves_with_paths(value):
                key = (io, f"[{pos}]{path}")
                actual = (str(leaf.device), _implied_global(leaf.shape, sh))
                with self._meta:
                    stored = baseline.setdefault(key, actual)
                want = stored
                if sh is not None and want_dev is not None:
                    # "cuda" names the current card: any index matches
                    dev = (actual[0] if actual[0].split(":")[0] == want_dev
                           else want_dev)
                    want = (dev, stored[1])
                if actual != want:
                    self._record(site, kind, key[1], want, actual,
                                 "global shape" if sh is not None
                                 else "shape")

    def _record(self, site: str, kind: str, path: str, want, actual,
                shape_word: str) -> None:
        with self._meta:
            self._counts[kind] = self._counts.get(kind, 0) + 1
            dedup = (site, kind, path)
            if dedup in self._reported:
                return
            self._reported.add(dedup)
            self._violations.append(Violation(
                kind=kind, site=site,
                message=(f"arg {path} arrived on {actual[0]} with "
                         f"{shape_word} {actual[1]} but the site placed it "
                         f"on {want[0]} with {shape_word} {want[1]} — the "
                         "step runs on a copy or a block of the wrong "
                         "width every dispatch"),
                details=(path, str(want), str(actual))))

    # ----------------------------------------------------------- results
    def violations(self) -> list[Violation]:
        with self._meta:
            return list(self._violations)

    def counts(self) -> dict[str, int]:
        """Per-kind OCCURRENCE counts (violations() is deduped per leaf)."""
        with self._meta:
            return dict(self._counts)

    def reset(self) -> None:
        """Clear findings and occurrence counts; enable state is kept.
        Per-wrapper baselines are NOT cleared (they die with the step
        function they describe)."""
        with self._meta:
            self._violations.clear()
            self._reported.clear()
            self._counts = {"resharded-input": 0, "resharded-output": 0}

    def report(self) -> str:
        vs = self.violations()
        if not vs:
            return "shardguard: clean (0 violations)"
        lines = [f"shardguard: {len(vs)} violation(s)"]
        lines += [f"  {v}" for v in vs]
        return "\n".join(lines)

    def emit_metrics(self) -> None:
        """Publish occurrence counts on the observability registry."""
        from ..observability import METRICS
        counts = self.counts()
        for kind in ("resharded-input", "resharded-output"):
            METRICS.gauge(
                "shardguard.violations." + kind.replace("-", "_"),
                counts.get(kind, 0))


SHARDGUARD = ShardGuard()
if enabled_from_env():   # a whole process, e.g. each rank of a run
    SHARDGUARD.enable()


@contextlib.contextmanager
def shardguard_active(guard: ShardGuard | None = None):
    """Enable around a block, disable after; yields the guard."""
    g = guard or SHARDGUARD
    g.enable()
    try:
        yield g
    finally:
        g.disable()
