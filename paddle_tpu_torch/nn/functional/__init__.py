"""nn.functional of the port: the attention dispatcher."""
from .flash_attention import (
    flash_attention,
    flash_attn_unpadded,
    flashmask_attention,
    get_last_attention_backend,
    scaled_dot_product_attention,
)

__all__ = ["flash_attention", "flash_attn_unpadded", "flashmask_attention",
           "scaled_dot_product_attention", "get_last_attention_backend"]
