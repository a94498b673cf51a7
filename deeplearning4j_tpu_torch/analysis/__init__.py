"""graftlint for the PyTorch/CUDA port — static hazard analysis + runtime
guards.

Port of ``deeplearning4j_tpu/analysis/``; two halves of one contract
(DESIGN.md §11):

- **static**: an AST rule engine (``engine.Analyzer``) with the rules of
  ``rules.py`` for torch code — host syncs in hot paths (HS01), seed
  reuse (RNG01), branches on device tensors (TB01), uninstrumented hot
  loops (HOT02), kernels without a plain version (PL01), the
  concurrency, observability, paging, control and sharding rules —
  plus per-line suppressions and a committed baseline
  (``graftlint_torch.baseline.json``) so ``python -m
  deeplearning4j_tpu_torch.analysis --check`` gates on *new* findings
  only.  It parses source and never imports the code it lints.
- **runtime**: ``runtime.hot_loop_guard()`` wraps the trainer's ``fit``
  loop and the engine's decode segments so a host sync fails loudly at
  its call site on the guarded thread (opt out:
  ``DL4J_TPU_TRANSFER_GUARD=0``), ``lockguard.LOCKGUARD`` instruments
  ``threading`` locks to detect lock-order inversions and Eraser-style
  unguarded shared writes (``DL4J_TPU_LOCKGUARD=1``), and
  ``shardguard.SHARDGUARD`` diffs the placements crossing wrapped step
  dispatches against the declared ``NamedSharding``s or the first call's
  (``DL4J_TPU_SHARDGUARD=1``).

The static sharding tier (SH01, SH02, NM01) resolves mesh-axis bindings
interprocedurally in ``sharding.ShardingInfo``; its canonical axis
registry is parsed from the port's ``parallel/mesh.py``.

Results flow through the observability layer as
``graftlint.violations.<RULE>`` and ``shardguard.violations.<kind>``
gauges (``report.emit_metrics`` / ``ShardGuard.emit_metrics``).
"""

from .baseline import Baseline
from .core import ACTIVE, BASELINED, SUPPRESSED, Finding, Rule, all_rules
from .engine import Analyzer, active
from .jitinfo import JitInfo, ModuleInfo
from .lockguard import (ENV_LOCKGUARD, LOCKGUARD, LockGuard, Violation,
                        enabled_from_env, lockguard_active)
from .report import emit_metrics, summarize, to_json, to_text
from .runtime import ENV_FLAG, allow_transfers, guard_mode, hot_loop_guard
from .sharding import ShardingInfo, axis_registry, sharding_info
from .shardguard import (ENV_SHARDGUARD, SHARDGUARD, ShardGuard,
                         shardguard_active)

__all__ = [
    "ACTIVE", "Analyzer", "BASELINED", "Baseline", "ENV_FLAG",
    "ENV_LOCKGUARD", "ENV_SHARDGUARD", "Finding", "JitInfo", "LOCKGUARD",
    "LockGuard", "ModuleInfo", "Rule", "SHARDGUARD", "SUPPRESSED",
    "ShardGuard", "ShardingInfo", "Violation", "active", "all_rules",
    "allow_transfers", "axis_registry", "emit_metrics", "enabled_from_env",
    "guard_mode", "hot_loop_guard", "lockguard_active", "sharding_info",
    "shardguard_active", "summarize", "to_json", "to_text",
]
