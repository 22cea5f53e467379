"""Dropout layers — the counterpart of ``paddle_tpu/nn/layer_common.py:61-100``
(``Dropout``, ``Dropout2D``, ``Dropout3D``, ``AlphaDropout``): each applies
its functional with ``training`` taken from the module's mode."""
from __future__ import annotations

from torch import nn

from .functional import common as F

__all__ = ["Dropout", "Dropout2D", "Dropout3D", "AlphaDropout"]


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
