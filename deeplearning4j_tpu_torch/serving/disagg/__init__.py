"""Disaggregated prefill/decode serving.

Port of ``deeplearning4j_tpu/serving/disagg``.  Prefill is compute-bound
and bursty, decode memory-bound and steady; colocated, a long prompt
landing mid-segment spikes the inter-token tail.  This package splits
them into tiers: prefill-role engines fill KV pages and never decode, a
:class:`KVMigrator` moves a request's pages into a decode engine's pool
(content-addressed: a page resident there moves as a hash-only claim),
and a :class:`DisaggScheduler` drives the pipeline and requeues, never
corrupts, when a prefill worker dies.

Every pool acquire and release and every block-table write of this
package lives inside the migrator's export and import seams.
"""

from .migrate import KVMigrator, PageTransfer, TransferPlan, export_payload
from .scheduler import DisaggScheduler

__all__ = [
    "DisaggScheduler",
    "KVMigrator",
    "PageTransfer",
    "TransferPlan",
    "export_payload",
]
