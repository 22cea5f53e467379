"""Memory-efficient attention — the counterpart of
``paddle_tpu/incubate/nn/memory_efficient_attention.py``.

Another entry point onto the flash kernels: with no bias or the causal one
the call is ``F.flash_attention`` (the kernel on CUDA), with q pre-scaled
by ``scale * sqrt(D)`` in q's dtype when ``scale`` is given, as JAX does,
since the kernel applies 1/sqrt(D); with dropout in training that call
takes the plain route (``F.flash_attention``). A bias tensor takes the JAX
package's XLA route in plain PyTorch: scores plus the bias, softmax in f32,
dropout on the f32 probabilities (the mask from the port's default
generator, ``nn.functional.common.keep_mask``). It takes the paddle-style
``Tensor`` as well (``tensor_seam``) and returns the kind it was given.
"""
from __future__ import annotations

import math

import torch

from ...tensor import tensor_seam

__all__ = ["memory_efficient_attention"]


@tensor_seam
def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True):
    """query/key/value: [B, S, H, D] (paddle layout). attn_bias: None, the
    string "causal", or a tensor broadcastable to [B, H, Sq, Sk]. Returns
    [B, S, H, D]. ``p``: attention dropout, applied in training."""
    from ...nn import functional as F
    from ...nn.functional.common import keep_mask

    if isinstance(attn_bias, str) and attn_bias.lower() != "causal":
        raise ValueError(f"attn_bias: 'causal', None or a tensor, got "
                         f"{attn_bias!r}")
    causal = isinstance(attn_bias, str)
    if causal or attn_bias is None:
        q = query
        if scale is not None:
            ratio = scale * math.sqrt(query.shape[-1])
            if abs(ratio - 1.0) > 1e-9:
                q = query * ratio
        out, _ = F.flash_attention(q, key, value,
                                   dropout=p if training else 0.0,
                                   causal=causal, training=training)
        return out
    s = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", query, key) * s
    logits = logits + attn_bias.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    if p and training:
        keep = 1.0 - p
        probs = torch.where(keep_mask(probs.shape, keep, probs.device),
                            probs / keep, torch.zeros((), device=probs.device))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(value.dtype), value)
