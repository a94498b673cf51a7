"""Kernel candidate registry and the evidence-gated auto-pick.

Port of ``deeplearning4j_tpu/ops/pallas/registry.py`` with the same
semantics.  A candidate bundles a kernel entry point, its plain PyTorch
reference, the block configs a tuning battery would sweep and the
correctness tolerances the adoption gate enforces.  The hand-written CUDA
kernels register with ``source="cuda"``; the incumbents ("gather",
"f32", "ring", "unfused", "scan") are plain PyTorch code, registered with
``source="torch"``.

``autopick`` lets a candidate replace the incumbent only when

1. a tuning row proves it *correct* (its ``check`` dict passes the
   candidate's tolerances: plain ``max_err``-style upper bounds and/or
   ``min``-keyed lower bounds such as int8's top-1 agreement), and
2. its best measured metric beats the incumbent's best by the >2% margin,
   where no incumbent evidence means no adoption (never adopt by void).

Every dropped candidate lands in ``Pick.dropped`` with the reason, and
every pick is published as ``bench.autopick.<kind>.*`` gauges
(``observability.kernels.publish_autopick``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Iterable, Mapping

from ...observability.kernels import publish_autopick

#: kernel modules imported on first registry use (they register at import)
_KERNEL_MODULES = (
    "deeplearning4j_tpu_torch.ops.cuda.matmul_int8",
    "deeplearning4j_tpu_torch.ops.cuda.paged_attention",
    "deeplearning4j_tpu_torch.ops.cuda.attention",
    "deeplearning4j_tpu_torch.ops.cuda.layernorm",
    "deeplearning4j_tpu_torch.ops.cuda.xent",
)


@dataclasses.dataclass(frozen=True)
class KernelCandidate:
    """One selectable implementation of a kernel kind."""

    kind: str                     # "int8_matmul" | "paged_attention" | ...
    name: str                     # registry key within the kind
    fn: Callable                  # kernel entry point
    reference: Callable | None = None   # plain PyTorch ground truth
    blocks: tuple = ()            # block configs a tuning battery sweeps
    tolerances: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    source: str = "cuda"          # "cuda" kernel or "torch" incumbent


@dataclasses.dataclass
class Pick:
    """One auto-pick decision."""

    kind: str
    choice: str
    reason: str
    dropped: list            # [{"candidate": name, "reason": why}, ...]
    considered: int          # tuning rows consulted for this kind


_REGISTRY: dict[tuple[str, str], KernelCandidate] = {}
_IMPORT_ERRORS: dict[str, str] = {}
_LOADED = False


def register(candidate: KernelCandidate) -> KernelCandidate:
    """Register a candidate; re-registering the same function is a no-op,
    a *different* candidate under a taken key is a programming error."""
    key = (candidate.kind, candidate.name)
    prev = _REGISTRY.get(key)
    if prev is not None and prev.fn is not candidate.fn:
        raise ValueError(f"kernel candidate {key} already registered")
    _REGISTRY[key] = candidate
    return candidate


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    for mod in _KERNEL_MODULES:
        try:
            importlib.import_module(mod)
        except Exception as e:  # its candidates stay absent, recorded
            _IMPORT_ERRORS[mod] = repr(e)[:200]


def import_errors() -> dict:
    """Kernel modules that failed to import, by module name (empty on a
    healthy install).  ``chip_smoke.py`` fails on a non-empty answer, and
    an engine on CUDA raises when the candidate it names is absent: a
    missing kernel never turns into the plain version quietly."""
    _ensure_loaded()
    return dict(_IMPORT_ERRORS)


def kinds() -> list[str]:
    _ensure_loaded()
    return sorted({k for k, _ in _REGISTRY})


def candidates(kind: str) -> list[KernelCandidate]:
    _ensure_loaded()
    return [c for (k, _), c in sorted(_REGISTRY.items()) if k == kind]


def get(kind: str, name: str) -> KernelCandidate:
    _ensure_loaded()
    try:
        return _REGISTRY[(kind, name)]
    except KeyError:
        avail = [c.name for c in candidates(kind)]
        raise KeyError(
            f"no kernel candidate {name!r} of kind {kind!r} "
            f"(registered: {avail})") from None


# --------------------------------------------------------------- adoption gate

def check_passes(cand: KernelCandidate, check: Mapping) -> tuple[bool, str]:
    """Apply ``cand.tolerances`` to one tuning ``check`` row.

    Plain keys in ``tolerances`` (e.g. ``max_err``) upper-bound every
    numeric value in the check row; the nested ``min`` mapping
    lower-bounds named keys (e.g. ``{"min": {"top1_agree": 0.999}}``).
    """
    if not isinstance(check, Mapping) or not check:
        return False, "empty correctness row"
    mins = cand.tolerances.get("min", {})
    max_err = cand.tolerances.get("max_err")
    for key, val in check.items():
        if not isinstance(val, (int, float)) or isinstance(val, bool):
            return False, f"non-numeric check value {key}={val!r}"
        if key in mins:
            if val < mins[key]:
                return False, f"{key}={val} below required {mins[key]}"
        elif max_err is not None and val >= max_err:
            return False, f"{key}={val} exceeds tolerance {max_err}"
    return True, "check passed"


def _best_metric(rows: Iterable[Mapping], name: str, metric: str):
    vals = [r[metric] for r in rows
            if r.get("candidate") == name
            and isinstance(r.get(metric), (int, float))
            and not isinstance(r.get(metric), bool)]
    return max(vals) if vals else None


def autopick(kind: str, rows: Iterable[Mapping], *, incumbent: str,
             metric: str = "tokens_per_sec", margin: float = 1.02) -> Pick:
    """Pick the production implementation for ``kind`` from tuning rows
    of the schema ``{"kernel": kind, "candidate": name, <metric>: float}``
    (measurements) and ``{"kernel": kind, "candidate": name, "check":
    {...}}`` (correctness evidence)."""
    _ensure_loaded()
    rows = [r for r in rows if isinstance(r, Mapping)
            and r.get("kernel") == kind]
    inc_best = _best_metric(rows, incumbent, metric)
    dropped: list[dict] = []
    eligible: list[tuple[float, KernelCandidate]] = []
    for cand in candidates(kind):
        if cand.name == incumbent:
            continue
        best = _best_metric(rows, cand.name, metric)
        if best is None:
            dropped.append({"candidate": cand.name,
                            "reason": f"no TUNE {metric} rows"})
            continue
        checks = [r["check"] for r in rows
                  if r.get("candidate") == cand.name
                  and isinstance(r.get("check"), Mapping)]
        if not checks:
            dropped.append({"candidate": cand.name,
                            "reason": "no correctness evidence"})
            continue
        verdicts = [check_passes(cand, c) for c in checks]
        if not any(ok for ok, _ in verdicts):
            dropped.append({"candidate": cand.name,
                            "reason": f"correctness gate: {verdicts[0][1]}"})
            continue
        if inc_best is None:
            dropped.append({"candidate": cand.name,
                            "reason": f"no incumbent ({incumbent}) evidence "
                                      "— never adopt by void"})
            continue
        if best <= inc_best * margin:
            dropped.append({"candidate": cand.name,
                            "reason": f"{metric} {best:.4g} within {margin:g}x"
                                      f" of {incumbent} {inc_best:.4g} "
                                      "(no >2% margin)"})
            continue
        eligible.append((best, cand))

    if eligible:
        eligible.sort(key=lambda bc: bc[0], reverse=True)
        best, winner = eligible[0]
        for lost, cand in eligible[1:]:
            dropped.append({"candidate": cand.name,
                            "reason": f"passed the gate but lost to "
                                      f"{winner.name} ({lost:.4g} vs "
                                      f"{best:.4g} {metric})"})
        pick = Pick(kind, winner.name,
                    f"TUNE: {winner.name} {best:.4g} > {incumbent} "
                    f"{inc_best:.4g} {metric} (>2% margin), check passed",
                    dropped, len(rows))
    else:
        pick = Pick(kind, incumbent,
                    f"default ({incumbent}: no TUNE evidence that a "
                    "candidate wins by >2%)", dropped, len(rows))
    publish_autopick(pick)
    return pick
