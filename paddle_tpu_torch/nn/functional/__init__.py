"""nn.functional of the port: gelu, silu, layer_norm, dropout, the
attention dispatcher and the packed attention forms of ``extra``."""
from .activation import gelu, silu
from .common import alpha_dropout, dropout, dropout2d, dropout3d
from .extra import flash_attn_qkvpacked, flash_attn_varlen_qkvpacked
from .flash_attention import (
    flash_attention,
    flash_attn_unpadded,
    flashmask_attention,
    get_last_attention_backend,
    scaled_dot_product_attention,
    sdp_kernel,
)
from .norm import layer_norm

__all__ = ["gelu", "silu", "layer_norm", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "flash_attention", "flash_attn_unpadded", "flashmask_attention",
           "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
           "scaled_dot_product_attention", "sdp_kernel",
           "get_last_attention_backend"]
