"""Serving tier of the port: continuous-batching engine, request queue,
paged KV bookkeeping, HTTP server and client, and the prefix-affinity
router in front of N engines (``router``).  The disaggregated tier
(``DisaggScheduler``, ``KVMigrator``, the migration records) is not
ported yet (``ROADMAP.md`` A8)."""

from .batcher import (Completion, DeadlineExceeded, GenerateRequest,
                      PagePoolExhausted, PendingResult, QueueFull,
                      RequestQueue, ScoreRequest, ServingRejected)
from .client import ServingClient, ServingError
from .engine import BatchScorer, InferenceEngine, ServingConfig, kv_page_bytes
from .paging import PagePool, PrefixEntry, prefix_chain_keys
from .router import (AllReplicasUnavailable, EngineReplica, HashRing,
                     PrefixRouter, ProcessReplica, ReplicaPool,
                     ReplicaUnavailable, RouterConfig, RouterServer)
from .server import ModelServer

__all__ = ["AllReplicasUnavailable", "BatchScorer", "Completion",
           "DeadlineExceeded", "EngineReplica", "GenerateRequest",
           "HashRing", "InferenceEngine", "ModelServer", "PagePool",
           "PagePoolExhausted", "PendingResult", "PrefixEntry",
           "PrefixRouter", "ProcessReplica", "QueueFull", "ReplicaPool",
           "ReplicaUnavailable", "RequestQueue", "RouterConfig",
           "RouterServer", "ScoreRequest", "ServingClient", "ServingConfig",
           "ServingError", "ServingRejected", "kv_page_bytes",
           "prefix_chain_keys"]
