"""paddle.incubate (counterpart of ``paddle_tpu/incubate``): the fused
functionals and layers (``nn``), ASP (``asp``), MoE on one device
(``distributed.models.moe``), and the top-level tail: the graph ops, the
fused softmax-mask ops, ``identity_loss``, ``LookAhead`` and
``ModelAverage``."""
from .. import inference  # noqa: F401
from . import asp, distributed, nn  # noqa: F401
from ._tail import (  # noqa: F401
    LookAhead,
    ModelAverage,
    graph_khop_sampler,
    graph_reindex,
    graph_sample_neighbors,
    graph_send_recv,
    identity_loss,
    segment_max,
    segment_mean,
    segment_min,
    segment_sum,
    softmax_mask_fuse,
    softmax_mask_fuse_upper_triangle,
)
