"""Serving stack of the port: paged KV cache, prefix cache, continuous
scheduler, warmup, HTTP."""
from .kv_cache import BlockAllocator, CacheOutOfBlocks, PagedKVCache
from .prefix_cache import PrefixCache, PrefixHit
from .resilience import Deadline, DeadlineExceeded, ServiceUnavailable
from .scheduler import ContinuousGenerateBatchingPredictor
from .serving import GenerateBatchingPredictor, InferenceServer

__all__ = ["BlockAllocator", "CacheOutOfBlocks", "PagedKVCache",
           "PrefixCache", "PrefixHit", "Deadline",
           "DeadlineExceeded", "ServiceUnavailable",
           "ContinuousGenerateBatchingPredictor", "GenerateBatchingPredictor",
           "InferenceServer"]
