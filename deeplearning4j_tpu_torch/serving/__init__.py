"""Serving tier of the port: continuous-batching engine, request queue,
paged KV bookkeeping, HTTP server and client, and the prefix-affinity
router in front of N engines (``router``), and the disaggregated
prefill/decode tier (``disagg``: ``DisaggScheduler`` drives prefill-role
engines whose KV pages ``KVMigrator`` moves into a decode engine)."""

from .batcher import (Completion, DeadlineExceeded, GenerateRequest,
                      PagePoolExhausted, PendingResult, QueueFull,
                      RequestQueue, ScoreRequest, ServingRejected)
from .client import ServingClient, ServingError
from .engine import (BatchScorer, InferenceEngine, MigrationRejected,
                     MigrationTicket, PrefillRecord, ServingConfig,
                     kv_page_bytes)
from .paging import PagePool, PrefixEntry, prefix_chain_keys
from .router import (AllReplicasUnavailable, EngineReplica, HashRing,
                     PrefixRouter, ProcessReplica, ReplicaPool,
                     ReplicaUnavailable, RouterConfig, RouterServer)
from .server import ModelServer
from .disagg import (DisaggScheduler, KVMigrator, PageTransfer, TransferPlan,
                     export_payload)

__all__ = ["AllReplicasUnavailable", "BatchScorer", "Completion",
           "DeadlineExceeded", "DisaggScheduler", "EngineReplica",
           "GenerateRequest", "HashRing", "InferenceEngine", "KVMigrator",
           "MigrationRejected", "MigrationTicket", "ModelServer",
           "PageTransfer", "PagePool",
           "PagePoolExhausted", "PendingResult", "PrefillRecord",
           "PrefixEntry",
           "PrefixRouter", "ProcessReplica", "QueueFull", "ReplicaPool",
           "ReplicaUnavailable", "RequestQueue", "RouterConfig",
           "RouterServer", "ScoreRequest", "ServingClient", "ServingConfig",
           "ServingError", "ServingRejected", "TransferPlan",
           "export_payload", "kv_page_bytes", "prefix_chain_keys"]
