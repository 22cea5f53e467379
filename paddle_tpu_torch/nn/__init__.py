"""nn layers of the port: LayerNorm, RMSNorm, Embedding, dropout, gradient
clipping, and ``functional`` (activations, norms, dropout and the
attention dispatcher)."""
from . import functional
from .clip import (
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
    clip_grad_norm_,
    clip_grad_value_,
)
from .layer_common import (
    AlphaDropout,
    Dropout,
    Dropout2D,
    Dropout3D,
    Embedding,
)
from .layer_conv_norm import LayerNorm, RMSNorm, rms_norm

__all__ = ["LayerNorm", "RMSNorm", "rms_norm", "Embedding", "Dropout",
           "Dropout2D", "Dropout3D", "AlphaDropout", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_",
           "clip_grad_value_", "functional"]
