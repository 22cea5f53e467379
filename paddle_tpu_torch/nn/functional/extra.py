"""The packed-qkv attention forms — the counterpart of two functions of
``paddle_tpu/nn/functional/extra.py`` (:415-445), and only of those two;
the rest of that module is not ported yet. (The JAX functions import the
name ``flash_attention`` from their package, where it is the function and
not the module, and raise AttributeError; these compute what they mean.)"""
from __future__ import annotations

import math

from .flash_attention import flash_attention, flash_attn_unpadded

__all__ = ["flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked"]


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         training=True, name=None):
    """qkv: [B, S, 3, H, D] packed; ``flash_attention`` on its three
    parts. Returns ``(out, None)``."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                max_seqlen_k, scale=None, dropout=0.0,
                                causal=False, return_softmax=False,
                                training=True, name=None):
    """qkv: [total, 3, H, D] packed documents; ``flash_attn_unpadded`` on
    its three parts, scale 1/sqrt(D) by default. Returns ``(out, None)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(qkv.shape[-1])
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens_q,
                               cu_seqlens_k, max_seqlen_q, max_seqlen_k,
                               scale, dropout=dropout, causal=causal,
                               training=training)
