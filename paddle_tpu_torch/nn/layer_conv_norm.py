"""Normalisation layers — the counterpart of
``paddle_tpu/nn/layer_conv_norm.py`` (``LayerNorm`` :208, ``RMSNorm``
:231) and ``nn/functional/norm.py::rms_norm``. ``amp.decorate`` at O2
leaves ``LayerNorm`` in f32, as the JAX package does, and casts
``RMSNorm``."""
from __future__ import annotations

import torch
from torch import nn

from .functional.norm import layer_norm

__all__ = ["LayerNorm", "RMSNorm", "rms_norm"]


def rms_norm(x, weight=None, epsilon=1e-6):
    """Mean square in f32, normalised value cast back to x's dtype, then
    scaled by ``weight`` (the JAX package's order of casts)."""
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out * weight if weight is not None else out


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))
        self.epsilon = epsilon

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    """Weight 1 and bias 0 over ``normalized_shape``, epsilon 1e-5 (JAX's
    defaults); ``weight_attr`` / ``bias_attr`` False drop the parameter."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(self.normalized_shape, device=device, dtype=dtype)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(self.normalized_shape, device=device, dtype=dtype)))

    def reset_parameters(self, generator=None):
        if self.weight is not None:
            nn.init.ones_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)
