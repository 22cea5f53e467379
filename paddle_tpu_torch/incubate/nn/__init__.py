"""Fused functional ops and memory-efficient attention (counterpart of
``paddle_tpu/incubate/nn``)."""
from .memory_efficient_attention import memory_efficient_attention

__all__ = ["memory_efficient_attention"]
