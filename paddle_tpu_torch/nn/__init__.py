"""nn layers of the port: RMSNorm, gradient clipping, and ``functional``
(the attention dispatcher)."""
from . import functional
from .clip import (
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
    clip_grad_norm_,
    clip_grad_value_,
)
from .layer_conv_norm import RMSNorm, rms_norm

__all__ = ["RMSNorm", "rms_norm", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "clip_grad_value_",
           "functional"]
