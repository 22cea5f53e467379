"""paddle.nn of the port — the counterpart of ``paddle_tpu/nn``: ``Layer``
(a ``torch.nn.Module``), ``Parameter``, ``ParamAttr``, the initializers,
the layers (common, conv / norm / pool, losses, transformer, recurrent,
the fill-ins of ``layer_extra``), gradient clipping, ``utils`` and
``functional``: every name ``paddle_tpu.nn`` exports."""
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
from . import layer_extra, layer_rnn
from .layer_rnn import *  # noqa: F401,F403
from .layer_rnn import __all__ as _rnn
from .layer_extra import *  # noqa: F401,F403
from .layer_extra import __all__ as _extra

__all__ = (["Layer", "Parameter", "ParamAttr", "ClipGradByGlobalNorm",
            "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
            "clip_grad_value_", "functional", "initializer", "utils"]
           + _common + _conv_norm + _loss + _transformer
           + sorted(set(_rnn) | set(_extra)))
