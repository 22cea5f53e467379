"""Embedding and dropout layers — the counterpart of
``paddle_tpu/nn/layer_common.py:40-100`` (``Embedding``, ``Dropout``,
``Dropout2D``, ``Dropout3D``, ``AlphaDropout``): each dropout applies its
functional with ``training`` taken from the module's mode."""
from __future__ import annotations

import torch
from torch import nn

from .functional import common as F

__all__ = ["Embedding", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout"]


class Embedding(nn.Module):
    """A [num_embeddings, embedding_dim] table, Xavier-normal (JAX :40-52);
    the ``padding_idx`` row (negative counts from the end) starts at 0 and
    always looks up as 0."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None,
                 dtype=None):
        super().__init__()
        self.padding_idx = (None if padding_idx is None else
                            padding_idx if padding_idx >= 0
                            else num_embeddings + padding_idx)
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def reset_parameters(self, generator=None):
        nn.init.xavier_normal_(self.weight, generator=generator)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0

    def forward(self, x):
        out = self.weight[x]
        if self.padding_idx is None:
            return out
        return torch.where((x == self.padding_idx)[..., None],
                           torch.zeros((), dtype=out.dtype,
                                       device=out.device), out)


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(nn.Module):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(nn.Module):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(nn.Module):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)
