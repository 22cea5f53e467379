"""Normalisation functionals — the counterpart of ``layer_norm`` in
``paddle_tpu/nn/functional/norm.py:178-195`` (``rms_norm`` lives beside
its layer in ``nn/layer_conv_norm.py``)."""
from __future__ import annotations

import torch

from ...amp import _amp_cast

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Mean and biased variance over the trailing ``normalized_shape`` axes
    in f32, then scale and shift in f32, cast back to x's dtype (the JAX
    package's order of casts). Under AMP O1 the op ``layer_norm`` is
    black-listed: x comes in, and the result goes out, in f32."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = _amp_cast("layer_norm", x, weight, bias)
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    x32 = x.float()
    mean = x32.mean(dim=axes, keepdim=True)
    var = (x32 - mean).square().mean(dim=axes, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
