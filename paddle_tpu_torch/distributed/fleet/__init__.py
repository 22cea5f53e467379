"""Fleet — the counterpart of ``paddle_tpu/distributed/fleet``: the hybrid
group over the world's ranks (``init``), the tensor-parallel layer library,
sequence parallelism, the hybrid optimizer, recompute and pipeline
parallelism (``PipelineLayer``, ``LayerDesc``, ``SharedLayerDesc``,
``PipelineParallel`` and its interleaved form) and elastic training
(``elastic``: ``ElasticManager`` over the launcher's store,
``AutoCheckpointer``)."""
from __future__ import annotations

from . import elastic, meta_parallel, sequence_parallel_utils  # noqa: F401
from .base import (  # noqa: F401
    CommunicateTopology, DistributedStrategy, HybridCommunicateGroup,
    PaddleCloudRoleMaker,
)
from .fleet_api import (  # noqa: F401
    distributed_model, distributed_optimizer, fleet_obj as _fleet,
    get_hybrid_communicate_group, init,
)
from .hybrid_optimizer import (  # noqa: F401
    HybridParallelClipGrad, HybridParallelOptimizer,
)
from .meta_parallel import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    SegmentParallel, TensorParallel, VocabParallelEmbedding,
)
from .pipeline import (  # noqa: F401
    LayerDesc, PipelineLayer, PipelineParallel,
    PipelineParallelWithInterleave, SegmentLayers, SharedLayerDesc,
)
from .recompute import recompute, recompute_sequential  # noqa: F401
from .sequence_parallel_utils import (  # noqa: F401
    AllGatherOp, ColumnSequenceParallelLinear, GatherOp, ReduceScatterOp,
    RowSequenceParallelLinear, ScatterOp, mark_as_sequence_parallel_parameter,
)


def worker_num():
    return _fleet.worker_num()


def worker_index():
    return _fleet.worker_index()


def is_first_worker():
    return _fleet.worker_index() == 0


def barrier_worker():
    _fleet.barrier_worker()


def get_rank():
    from .. import env

    return env.get_rank()

