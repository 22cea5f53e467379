"""``paddle.distributed.utils`` (the counterpart of
``paddle_tpu/distributed/utils``): the MoE exchanges."""
from . import moe_utils  # noqa: F401
from .moe_utils import global_gather, global_scatter  # noqa: F401
