from .admission import ReplicaDrainingError, RequestTooLargeError, ServeError
from .batcher import select_bucket
from .engine import ServeConfig
from .generation import GenerationSession
from .metrics import ServeMetrics
from .prefix_cache import PrefixCache

__all__ = ["GenerationSession", "PrefixCache", "ReplicaDrainingError",
           "RequestTooLargeError", "ServeConfig", "ServeError",
           "ServeMetrics", "select_bucket"]
