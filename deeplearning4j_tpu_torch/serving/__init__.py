"""Serving tier of the port: continuous-batching engine, request queue,
paged KV bookkeeping, HTTP server and client."""

from .batcher import (Completion, DeadlineExceeded, GenerateRequest,
                      PagePoolExhausted, PendingResult, QueueFull,
                      RequestQueue, ScoreRequest, ServingRejected)
from .client import ServingClient, ServingError
from .engine import BatchScorer, InferenceEngine, ServingConfig, kv_page_bytes
from .paging import PagePool, PrefixEntry, prefix_chain_keys
from .server import ModelServer

__all__ = ["BatchScorer", "Completion", "DeadlineExceeded",
           "GenerateRequest", "InferenceEngine", "ModelServer", "PagePool",
           "PagePoolExhausted", "PendingResult", "PrefixEntry", "QueueFull",
           "RequestQueue", "ScoreRequest", "ServingClient", "ServingConfig",
           "ServingError", "ServingRejected", "kv_page_bytes",
           "prefix_chain_keys"]
