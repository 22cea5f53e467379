"""Auto-parallel — the counterpart of
``paddle_tpu/distributed/auto_parallel``: the ``parallelize`` plans, the
``Strategy`` tree and ``to_static`` / ``DistModel`` (reference
``python/paddle/distributed/auto_parallel/``: api.py, strategy.py,
intermediate/)."""
from .dist_model import DistModel, LocalLayer, to_static  # noqa: F401
from .parallelize import (  # noqa: F401
    ColWiseParallel, PlanBase, PrepareLayerInput, PrepareLayerOutput,
    RowWiseParallel, SequenceParallelBegin, SequenceParallelDisable,
    SequenceParallelEnable, SequenceParallelEnd, SplitPoint,
    ToDistributedConfig, parallelize, to_distributed,
)
from .strategy import Strategy  # noqa: F401
from ..mesh import get_mesh, set_mesh  # noqa: F401
