"""Convolutions — the counterpart of ``paddle_tpu/nn/functional/conv.py``
(JAX's are ``lax.conv_general_dilated``; the port's are torch's, cuDNN on
the card). The weight is paddle's in both layouts: ``[out, in / groups,
*k]``, and ``[in, out / groups, *k]`` for a transpose.

Channels-last inputs (``NLC``, ``NHWC``, ``NDHWC``) are logical [N, *S,
C]. Torch convolves logical NC...; the input goes in as a permuted VIEW
(free: [N, H, W, C] memory is channels_last memory of the [N, C, H, W]
view), and the output comes back as the permuted view of torch's
channels-last result, so no layout copy is made per convolution when the
weight is kept channels-last too (``Conv2D`` does so for NHWC).

``padding``: an int, one per spatial dim, [lo, hi] pairs (flat or
nested), or "SAME" / "VALID" as XLA pads them (SAME: total max((ceil(in /
s) - 1) s + (k - 1) d + 1 - in, 0), the odd unit at the end). Asymmetric
padding is applied with an explicit pad first.
"""
from __future__ import annotations

import math

import torch.nn.functional as tF

from ...ops import apply_like

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _pairs(padding, n, in_sizes, k, strides, dilations):
    """[(lo, hi)] per spatial dim."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        pairs = []
        for i in range(n):
            eff = (k[i] - 1) * dilations[i] + 1
            total = max((math.ceil(in_sizes[i] / strides[i]) - 1)
                        * strides[i] + eff - in_sizes[i], 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(p) for p in padding]


def _torch_pad(pairs):
    """F.pad's flat list (last dim first) of [(lo, hi)] per spatial dim."""
    return [w for lo_hi in reversed(pairs) for w in lo_hi]


_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}


def _to_ncx(v, chan_last):
    return v.movedim(-1, 1) if chan_last else v


def _from_ncx(v, chan_last):
    return v.movedim(1, -1) if chan_last else v


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          chan_last):
    strides, dilations = _tuple(stride, n), _tuple(dilation, n)

    def f(v, w, b):
        v = _to_ncx(v, chan_last)
        pairs = _pairs(padding, n, v.shape[2:], w.shape[2:], strides,
                       dilations)
        if all(lo == hi for lo, hi in pairs):
            pad = [lo for lo, _ in pairs]
        else:
            v = tF.pad(v, _torch_pad(pairs))
            pad = 0
        out = _CONV[n](v, w, b, strides, pad, dilations, groups)
        return _from_ncx(out, chan_last)

    return apply_like(f, f"conv{n}d", x, weight, bias)


def _chan_last(data_format):
    return data_format.endswith("C")


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format in ("NLC", "NWC"))


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 _chan_last(data_format))


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 _chan_last(data_format))


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, chan_last):
    """The full transposed convolution (no padding), then each spatial dim
    cropped by its low pad at the start and by (high pad - output_padding)
    at the end (negative: zeros appended), then the bias: XLA's
    lhs-dilated convolution of JAX :111-165, where a pad may differ at the
    two ends."""
    strides, dilations = _tuple(stride, n), _tuple(dilation, n)
    opad = (_tuple(output_padding, n) if output_padding is not None
            else (0,) * n)

    def f(v, w, b):
        v = _to_ncx(v, chan_last)
        k = w.shape[2:]
        if isinstance(padding, str) and padding.upper() == "SAME":
            pairs = []
            for i in range(n):
                total = max((k[i] - 1) * dilations[i] + 1 - strides[i], 0)
                pairs.append((total // 2, total - total // 2))
        else:
            pairs = _pairs(padding, n, None, k, strides, dilations)
        out = _CONV_T[n](v, w, None, strides, 0, 0, groups, dilations)
        crop = [(-lo, op - hi) for (lo, hi), op in zip(pairs, opad)]
        if any(c for pair in crop for c in pair):
            out = tF.pad(out, _torch_pad(crop))
        if b is not None:
            out = out + b.reshape((1, -1) + (1,) * n)
        return _from_ncx(out, chan_last)

    return apply_like(f, f"conv{n}d_transpose", x, weight, bias)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format in ("NLC",
                                                                "NWC"))


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, _chan_last(data_format))


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, _chan_last(data_format))
