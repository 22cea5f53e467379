"""``python -m paddle_tpu_torch.distributed.launch`` — the launcher: the
counterpart of ``paddle_tpu/distributed/launch`` (reference
``python/paddle/distributed/launch``)."""
from .context import Context, parse_args  # noqa: F401
from .controller import CollectiveController  # noqa: F401
from .main import launch, main  # noqa: F401
