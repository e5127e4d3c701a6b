"""Serving in the port: `GenerationSession` (token-level continuous
batching over a cache-carrying model: bucketed or paged KV, exact or
int8 pages, speculative decoding, the host tier, drain / evacuate) and
`ServeEngine` (a request-shaped endpoint over a compiled function:
shape buckets, a micro-batcher, admission, degradation, a circuit
breaker), configured by one `ServeConfig`."""

from .admission import (CircuitOpenError, DeadlineExceededError,
                        EngineStoppedError, ExecTimeoutError,
                        QueueFullError, ReplicaDrainingError,
                        RequestTooLargeError, ServeError, is_oom_error,
                        is_transient_error, retry_transient)
from .batcher import (MicroBatcher, PackMeta, Request, RequestQueue,
                      pack_requests, scatter_results, select_bucket)
from .engine import ServeConfig, ServeEngine
from .generation import GenerationSession, kv_cache_specs
from .metrics import LatencyHistogram, ServeMetrics
from .prefix_cache import PrefixCache, chunk_key
from .speculate import NGramDrafter, SmallModelDrafter, accept_length

__all__ = ["CircuitOpenError", "DeadlineExceededError", "EngineStoppedError",
           "ExecTimeoutError", "GenerationSession", "LatencyHistogram",
           "MicroBatcher", "NGramDrafter", "PackMeta", "PrefixCache",
           "QueueFullError", "ReplicaDrainingError", "Request",
           "RequestQueue", "RequestTooLargeError", "ServeConfig",
           "ServeEngine", "ServeError", "ServeMetrics", "SmallModelDrafter",
           "accept_length", "chunk_key", "is_oom_error",
           "is_transient_error", "kv_cache_specs", "pack_requests",
           "retry_transient",
           "scatter_results", "select_bucket"]
