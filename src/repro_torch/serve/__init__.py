"""Continuous-batching decode serving of the port: queue, paged cache,
block prefill, batcher and executor (after ``src/repro/serve/``)."""

from repro_torch.serve.batcher import (
    ContinuousBatcher,
    ServeConfig,
    decode_buckets,
    fused_step,
)
from repro_torch.serve.cache import (
    CacheSpec,
    PagedCache,
    PagedCacheError,
    build_spec,
    dense_cache_bytes,
    gather_dense,
    scatter_token,
)
from repro_torch.serve.executor import (
    OK_STATUSES,
    STATUS_ERROR,
    STATUS_FALLBACK,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHED_DEADLINE,
    STATUS_SHED_OVERFLOW,
    RequestResult,
    ServeExecutor,
    ServeStats,
)
from repro_torch.serve.prefill import chunked_prefill, greedy_generate
from repro_torch.serve.queue import (
    QueueClosed,
    QueueFull,
    Request,
    RequestQueue,
    ShedEvent,
    mint_trace_id,
)

__all__ = [
    "CacheSpec", "ContinuousBatcher", "OK_STATUSES", "PagedCache",
    "PagedCacheError", "QueueClosed", "QueueFull", "Request", "RequestQueue",
    "RequestResult", "STATUS_ERROR", "STATUS_FALLBACK", "STATUS_OK",
    "STATUS_REJECTED", "STATUS_SHED_DEADLINE", "STATUS_SHED_OVERFLOW",
    "ServeConfig", "ServeExecutor", "ServeStats", "ShedEvent", "build_spec",
    "chunked_prefill", "decode_buckets", "dense_cache_bytes", "fused_step",
    "gather_dense", "greedy_generate", "mint_trace_id", "scatter_token",
]
