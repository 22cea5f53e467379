"""nn layers of the port: RMSNorm, dropout, gradient clipping, and
``functional`` (dropout and the attention dispatcher)."""
from . import functional
from .clip import (
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
    clip_grad_norm_,
    clip_grad_value_,
)
from .layer_common import AlphaDropout, Dropout, Dropout2D, Dropout3D
from .layer_conv_norm import RMSNorm, rms_norm

__all__ = ["RMSNorm", "rms_norm", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "clip_grad_value_",
           "functional"]
