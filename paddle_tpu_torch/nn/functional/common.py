"""Dropout — the counterpart of ``paddle_tpu/nn/functional/common.py:29-74``
(``dropout``, ``dropout2d``, ``dropout3d``, ``alpha_dropout``).

Masks come from the port's default generator of the tensor's device
(``framework.default_generator``; JAX draws ``next_key()`` from its
default generator). A mask is one ``torch.bernoulli`` of a bool tensor
(``keep_mask``): one byte an element, and one op, so that a recomputed
region (``distributed.fleet.recompute``) keeps the forward's mask instead
of drawing another. Inside ``jit.TrainStep`` the generator is registered
with the step's CUDA graph, so each replay draws new masks.
"""
from __future__ import annotations

import torch

from ...framework import default_generator

__all__ = ["dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "keep_mask"]

_MODES = ("upscale_in_train", "downscale_in_infer")


def keep_mask(shape, keep, device):
    """A bool tensor of ``shape`` on ``device``, each element True with
    probability ``keep``, drawn from the device's default generator."""
    return torch.bernoulli(torch.empty(shape, dtype=torch.bool,
                                       device=device), keep,
                           generator=default_generator(device))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability ``p``. ``upscale_in_train``:
    survivors scaled by 1 / (1 - p) in training, identity in inference;
    ``downscale_in_infer``: survivors kept as they are in training, x * (1 -
    p) in inference. ``axis``: the mask varies only along these axes and
    is broadcast over the others (JAX :37-59)."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if not 0.0 <= float(p) <= 1.0:
        raise ValueError(f"p must lie in [0, 1], got {p}")
    if not training or p == 0:
        if mode == "downscale_in_infer" and not training and p:
            return (x * (1.0 - float(p))).to(x.dtype)
        return x
    pv = float(p)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = keep_mask(shape, 1.0 - pv, x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - pv), zero)
    return torch.where(keep, x, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """One mask entry per (sample, channel) of a 4-d input."""
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """One mask entry per (sample, channel) of a 5-d input."""
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped elements take alpha' = -alpha *
    scale, then an affine map a * x + b keeps the mean and variance (JAX
    :62-74)."""
    if not training or p == 0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = keep_mask(x.shape, 1.0 - p, x.device)
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    fill = torch.full((), alpha_p, dtype=x.dtype, device=x.device)
    return (a * torch.where(keep, x, fill) + b).to(x.dtype)
