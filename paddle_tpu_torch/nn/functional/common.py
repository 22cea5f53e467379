"""Common functionals — the counterpart of
``paddle_tpu/nn/functional/common.py``: linear, dropout, embedding,
one_hot, label_smooth, bilinear, cosine_similarity, interpolate, the
pixel / channel shuffles, fold, pad and the small sequence helpers. Each
returns the kind it is given (``ops.apply_like``).

Dropout masks come from the port's default generator of the tensor's
device (``framework.default_generator``; JAX draws ``next_key()`` from its
default generator). A mask is one ``torch.bernoulli`` of a bool tensor
(``keep_mask``): one byte an element, and one op, so that a recomputed
region (``distributed.fleet.recompute``) keeps the forward's mask instead
of drawing another. Inside ``jit.TrainStep`` the generator is registered
with the step's CUDA graph, so each replay draws new masks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...framework import default_generator
from ...ops import apply_like
from ...tensor import Tensor

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "keep_mask", "embedding", "one_hot", "label_smooth", "pad",
           "interpolate", "upsample", "bilinear", "cosine_similarity",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "fold",
           "unfold", "zeropad2d", "sequence_mask", "dice_loss",
           "temporal_shift"]

_MODES = ("upscale_in_train", "downscale_in_infer")


def linear(x, weight, bias=None, name=None):
    """x @ W + b, W in paddle's [in, out] layout."""
    if bias is None:
        return apply_like(torch.matmul, "linear", x, weight)
    return apply_like(lambda v, w, b: torch.matmul(v, w) + b, "linear", x,
                      weight, bias)


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
            return apply_like(lambda v: (v * (1.0 - float(p))).to(v.dtype),
                              "dropout", x)
        return x
    pv = float(p)

    def f(v):
        shape = list(v.shape)
        if axis is not None:
            axes = [axis] if isinstance(axis, int) else list(axis)
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = keep_mask(shape, 1.0 - pv, v.device)
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        if mode == "upscale_in_train":
            return torch.where(keep, v / (1.0 - pv), zero)
        return torch.where(keep, v, zero)

    return apply_like(f, "dropout", x)


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
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p

    def f(v):
        keep = keep_mask(v.shape, 1.0 - p, v.device)
        fill = torch.full((), alpha_p, dtype=v.dtype, device=v.device)
        return (a * torch.where(keep, v, fill) + b).to(v.dtype)

    return apply_like(f, "alpha_dropout", x)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at ``x``; the ``padding_idx`` row (negative counts
    from the end) looks up as 0."""
    if padding_idx is not None and padding_idx < 0:
        padding_idx += weight.shape[0]

    def f(i, w):
        out = w[i]
        if padding_idx is None:
            return out
        return torch.where((i == padding_idx)[..., None],
                           torch.zeros((), dtype=out.dtype,
                                       device=out.device), out)

    return apply_like(f, "embedding", x, weight)


def one_hot(x, num_classes, name=None):
    from ...ops.creation import one_hot as _one_hot

    out = _one_hot(x, num_classes)
    return out if isinstance(x, Tensor) else out._value


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def f(lv, pd):
        if pd is None:
            return (1 - epsilon) * lv + epsilon / lv.shape[-1]
        return (1 - epsilon) * lv + epsilon * pd

    return apply_like(f, "label_smooth", label, prior_dist)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``ops.manipulation.pad`` (constant, reflect, replicate, circular),
    of the kind given."""
    from ...ops import manipulation

    out = manipulation.pad(x, pad, mode, value, data_format)
    return out if isinstance(x, Tensor) else out._value


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col, ``ops.manipulation.unfold``, of the kind given."""
    from ...ops import manipulation

    out = manipulation.unfold(x, kernel_sizes, strides, paddings, dilations)
    return out if isinstance(x, Tensor) else out._value


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def _sizes(size):
    sizes = size if isinstance(size, (list, tuple)) else [size]
    return [int(s.item()) if isinstance(s, Tensor) else int(s)
            for s in sizes]


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes (JAX's ``jax.image.resize``): ``nearest``
    with half-pixel centres (torch's ``nearest-exact``), the linear family
    (``linear``, ``bilinear``, ``trilinear``; ``area`` is linear, as in
    JAX) with half-pixel centres and, when shrinking, the kernel widened by
    the scale (JAX's antialiasing; torch's ``antialias`` for 2-d), or
    ``align_corners`` sampling at corner-aligned coordinates. ``bicubic``
    is not ported: JAX's resize uses Keys' a = -0.5 and torch a = -0.75."""
    mode = mode.lower()
    if mode == "bicubic":
        raise NotImplementedError(
            "interpolate(mode='bicubic'): jax.image.resize's cubic kernel "
            "(a = -0.5) has no torch counterpart; not ported")

    def f(v):
        chan_last = data_format.endswith("C")
        nd = v.dim()
        if chan_last:
            v = v.movedim(-1, 1)
        in_sizes = list(v.shape[2:])
        if size is not None:
            sizes = _sizes(size)
        else:
            sf = (scale_factor if isinstance(scale_factor, (list, tuple))
                  else [scale_factor] * len(in_sizes))
            sizes = [int(round(i * float(s))) for i, s in zip(in_sizes, sf)]
        if mode == "nearest":
            out = tF.interpolate(v, size=sizes, mode="nearest-exact")
        elif align_corners and all(s > 1 for s in sizes):
            out = v
            for d, s in zip(range(2, nd), sizes):
                n_in = v.shape[d]
                coords = torch.linspace(0.0, n_in - 1, s, device=v.device,
                                        dtype=torch.float64)
                lo = torch.floor(coords).long()
                hi = torch.clamp(lo + 1, max=n_in - 1)
                shape = [1] * nd
                shape[d] = s
                w = (coords - lo).to(v.dtype).reshape(shape)
                out = (out.index_select(d, lo) * (1 - w)
                       + out.index_select(d, hi) * w)
        else:
            linear = {3: "linear", 4: "bilinear", 5: "trilinear"}[nd]
            shrink = any(s < i for s, i in zip(sizes, in_sizes))
            if shrink and nd != 4:
                raise NotImplementedError(
                    "interpolate: shrinking with the antialiased linear "
                    "kernel is ported for 2-d inputs only")
            out = tF.interpolate(v, size=sizes, mode=linear,
                                 align_corners=False,
                                 antialias=shrink and nd == 4)
        return out.movedim(1, -1) if chan_last else out

    return apply_like(f, "interpolate", x)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] W[o] x2[b] (+ bias)."""
    def f(a, b, w, bi):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out if bi is None else out + bi

    return apply_like(f, "bilinear", x1, x2, weight, bias)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def f(a, b):
        dot = torch.sum(a * b, dim=axis)
        na = torch.sqrt(torch.sum(a * a, dim=axis))
        nb = torch.sqrt(torch.sum(b * b, dim=axis))
        return dot / torch.clamp(na * nb, min=eps)

    return apply_like(f, "cosine_similarity", x1, x2)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def f(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            v = v.reshape(n, c // (r * r), r, r, h, w)
            return v.permute(0, 1, 4, 2, 5, 3).reshape(
                n, c // (r * r), h * r, w * r)
        n, h, w, c = v.shape
        v = v.reshape(n, h, w, r, r, c // (r * r))
        return v.permute(0, 1, 3, 2, 4, 5).reshape(
            n, h * r, w * r, c // (r * r))

    return apply_like(f, "pixel_shuffle", x)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def f(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            v = v.reshape(n, c, h // r, r, w // r, r)
            return v.permute(0, 1, 3, 5, 2, 4).reshape(
                n, c * r * r, h // r, w // r)
        n, h, w, c = v.shape
        v = v.reshape(n, h // r, r, w // r, r, c)
        return v.permute(0, 1, 3, 2, 4, 5).reshape(
            n, h // r, w // r, c * r * r)

    return apply_like(f, "pixel_unshuffle", x)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def f(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            v = v.reshape(n, groups, c // groups, h, w)
            return v.transpose(1, 2).reshape(n, c, h, w)
        n, h, w, c = v.shape
        v = v.reshape(n, h, w, groups, c // groups)
        return v.transpose(3, 4).reshape(n, h, w, c)

    return apply_like(f, "channel_shuffle", x)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of ``unfold``: [N, C*kh*kw, L] to [N, C, oh,
    ow]; ``paddings`` an int, [ph, pw] or [top, left, bottom, right]."""
    if isinstance(paddings, int):
        pt = pb = pl = pr = paddings
    elif len(paddings) == 2:
        pt = pb = paddings[0]
        pl = pr = paddings[1]
    else:
        pt, pl, pb, pr = paddings
    oh, ow = ((output_sizes, output_sizes) if isinstance(output_sizes, int)
              else output_sizes)

    def f(v):
        out = tF.fold(v, (oh + pt + pb, ow + pl + pr), kernel_sizes,
                      dilations, 0, strides)
        return out[:, :, pt:pt + oh, pl:pl + ow]

    return apply_like(f, "fold", x)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[..., maxlen]: 1 where the position is below the length. Without
    ``maxlen`` the longest length is read back to the host."""
    from ...framework import dtype as _dt

    if maxlen is None:
        v = x._value if isinstance(x, Tensor) else x
        maxlen = int(v.max())
    d = _dt.convert_dtype(dtype)

    def f(lens):
        pos = torch.arange(maxlen, device=lens.device)
        return (pos < lens[..., None].long()).to(d)

    return apply_like(f, "sequence_mask", x)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """Dice loss over the last (class probability) axis."""
    def f(pred, lab):
        oh = tF.one_hot(lab.squeeze(-1).long(), pred.shape[-1]).to(
            pred.dtype)
        red = tuple(range(1, pred.dim()))
        inter = (pred * oh).sum(red)
        union = pred.sum(red) + oh.sum(red)
        return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()

    return apply_like(f, "dice_loss", input, label)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift: the first ``shift_ratio`` of the channels one segment
    back in time, the next as many one forward, the rest kept."""
    def f(v):
        if data_format == "NHWC":
            v = v.movedim(-1, 1)
        nt, c, h, w = v.shape
        v = v.reshape(nt // seg_num, seg_num, c, h, w)
        k = int(c * shift_ratio)
        left = torch.cat([v[:, 1:, :k], torch.zeros_like(v[:, :1, :k])], 1)
        right = torch.cat([torch.zeros_like(v[:, :1, k:2 * k]),
                           v[:, :-1, k:2 * k]], 1)
        out = torch.cat([left, right, v[:, :, 2 * k:]], 2).reshape(
            nt, c, h, w)
        return out.movedim(1, -1) if data_format == "NHWC" else out

    return apply_like(f, "temporal_shift", x)

