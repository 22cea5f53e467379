"""paddle.nn of the port — the counterpart of ``paddle_tpu/nn``: ``Layer``
(a ``torch.nn.Module``), ``Parameter``, ``ParamAttr``, the initializers,
the layers (common, conv / norm / pool, losses, transformer), gradient
clipping, ``utils`` and ``functional``."""
from . import functional, initializer, utils
from .clip import (
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
    clip_grad_norm_,
    clip_grad_value_,
)
from .layer import Layer, Parameter, ParamAttr
from .layer_common import *  # noqa: F401,F403
from .layer_common import __all__ as _common
from .layer_conv_norm import *  # noqa: F401,F403
from .layer_conv_norm import _BatchNormBase  # noqa: F401
from .layer_conv_norm import __all__ as _conv_norm
from .layer_loss import *  # noqa: F401,F403
from .layer_loss import __all__ as _loss
from .layer_transformer import *  # noqa: F401,F403
from .layer_transformer import __all__ as _transformer

__all__ = (["Layer", "Parameter", "ParamAttr", "ClipGradByGlobalNorm",
            "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
            "clip_grad_value_", "functional", "initializer", "utils"]
           + _common + _conv_norm + _loss + _transformer)
