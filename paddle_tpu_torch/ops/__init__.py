"""Operators of the port: the paged attention kernel and the flash-attention
kernels (``ops.flash_attention``), each beside its plain twin."""
from .paged_attention import (
    paged_cache_update,
    paged_decode_attention,
    paged_decode_attention_ref,
    write_positions,
)

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "paged_cache_update", "write_positions"]
