"""Fused transformer layers, the fused functionals and memory-efficient
attention (counterpart of ``paddle_tpu/incubate/nn``)."""
from . import functional  # noqa: F401
from .fused_transformer import (
    FusedFeedForward,
    FusedMultiHeadAttention,
    FusedTransformerEncoderLayer,
)
from .memory_efficient_attention import memory_efficient_attention

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "functional",
           "memory_efficient_attention"]
