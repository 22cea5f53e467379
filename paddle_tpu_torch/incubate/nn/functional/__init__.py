"""RoPE and SwiGLU — the counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py:43-100``.

RoPE is the neox style (rotate halves) over the layout
[batch, seq, heads, head_dim], at per-row absolute positions [B, S]; the
frequencies are built in f32 and the sin/cos tables cast to the
activations' dtype before the rotation, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rope_cos_sin", "apply_rope", "swiglu"]


def swiglu(x, y=None):
    """silu(a) * b, with (a, b) the two halves of x's last axis (or x, y)."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


def rope_cos_sin(position_ids, head_dim, dtype, base=10000.0):
    """cos, sin tables [B, S, 1, D] for absolute positions [B, S]."""
    dev = position_ids.device
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=dev) / head_dim))
    freqs = position_ids.float()[..., None] * inv            # [B, S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)[:, :, None, :]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(t, cos, sin):
    """The rotation of t, with the tables cast to t's dtype (JAX casts them
    to q's, ``fused_rotary_position_embedding``: under AMP O1 q and k come
    from a white-listed linear in the amp dtype)."""
    half = t.shape[-1] // 2
    rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    return t * cos.to(t.dtype) + rot * sin.to(t.dtype)
