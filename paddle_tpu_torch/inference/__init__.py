"""Serving stack of the port: paged KV cache, prefix cache, continuous
scheduler, warmup, HTTP; and the load-and-serve predictor of a
``jit.save`` artifact (``Config``, ``Predictor``, ``create_predictor``)."""
from .kv_cache import BlockAllocator, CacheOutOfBlocks, PagedKVCache
from .predictor import Config, Predictor, create_predictor
from .prefix_cache import PrefixCache, PrefixHit
from .resilience import Deadline, DeadlineExceeded, ServiceUnavailable
from .scheduler import ContinuousGenerateBatchingPredictor
from .serving import GenerateBatchingPredictor, InferenceServer

__all__ = ["BlockAllocator", "CacheOutOfBlocks", "PagedKVCache",
           "PrefixCache", "PrefixHit", "Deadline",
           "DeadlineExceeded", "ServiceUnavailable",
           "ContinuousGenerateBatchingPredictor", "GenerateBatchingPredictor",
           "InferenceServer", "Config", "Predictor", "create_predictor"]
