"""nn layers of the port: RMSNorm, gradient clipping, and ``functional``
(the attention dispatcher)."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layer_conv_norm import RMSNorm, rms_norm

__all__ = ["RMSNorm", "rms_norm", "ClipGradByGlobalNorm", "functional"]
