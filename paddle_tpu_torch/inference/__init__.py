"""Serving stack of the port: paged KV cache, prefix cache, continuous
scheduler with multi-LoRA adapters and tenant QoS, warmup, resilience and
fault injection, HTTP, the replica fleet and its autoscaler; and the
load-and-serve predictor of a ``jit.save`` artifact (``Config``,
``Predictor``, ``create_predictor``)."""
from .adapters import BASE_SLOT, AdapterRegistry
from .faults import FaultInjector, ThreadDeath
from .kv_cache import BlockAllocator, CacheOutOfBlocks, PagedKVCache
from .predictor import Config, Predictor, create_predictor
from .prefix_cache import PrefixCache, PrefixHit
from .qos import FleetAutoscaler, TenantLedger, TenantSpec
from .resilience import (
    AdmissionController,
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    ServerBusy,
    ServiceUnavailable,
    Supervisor,
)
from .scheduler import (
    ContinuousGenerateBatchingPredictor,
    attribution_shares,
    phase_walls,
)
from .serving import (
    BatchingPredictor,
    GenerateBatchingPredictor,
    InferenceServer,
    ReplicaFleet,
    retry_after_header,
)

__all__ = ["BlockAllocator", "CacheOutOfBlocks", "PagedKVCache",
           "PrefixCache", "PrefixHit", "Deadline", "DeadlineExceeded",
           "ServerBusy", "ServiceUnavailable", "AdmissionController",
           "CircuitBreaker", "Supervisor", "FaultInjector", "ThreadDeath",
           "AdapterRegistry", "BASE_SLOT", "TenantLedger", "TenantSpec",
           "FleetAutoscaler", "ContinuousGenerateBatchingPredictor",
           "phase_walls", "attribution_shares", "BatchingPredictor",
           "GenerateBatchingPredictor", "InferenceServer", "ReplicaFleet",
           "retry_after_header", "Config", "Predictor", "create_predictor"]
