"""Activations — the counterpart of two functions of
``paddle_tpu/nn/functional/activation.py`` (``gelu`` :53, ``silu`` :57);
the rest of that module is not ported yet."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["gelu", "silu"]


def gelu(x, approximate=False, name=None):
    """x * Phi(x) with the exact erf (``jax.nn.gelu(approximate=False)``),
    or its tanh approximation with ``approximate=True``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    """x * sigmoid(x)."""
    return F.silu(x)
