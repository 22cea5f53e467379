"""Normalisation functionals — the counterpart of
``paddle_tpu/nn/functional/norm.py``: ``batch_norm`` (with JAX's
``residual`` / ``act`` extension and its hand-written backward),
``layer_norm``, ``rms_norm``, ``instance_norm``, ``group_norm``,
``local_response_norm`` and ``normalize``, each under its JAX op name and
of the kind it is given (``ops.apply_like``).

Batch norm in training (JAX :34-175) is one ``autograd.Function``,
``_BNTrain``: statistics in f32 with the exact two-pass variance, the
normalised output (plus ``residual``, then ``relu``) cast back to x's
dtype; the backward keeps x in its own dtype and recomputes the
normalised value, and for ``relu`` reads the mask from the output. The
running statistics are kept as paddle keeps them, ``momentum * old + (1 -
momentum) * batch`` with the variance unbiased by n / (n - 1), written IN
PLACE into the tensors given (``copy_`` under ``no_grad``, each in its own
dtype), so a captured ``jit.TrainStep`` replays the update into the same
storage a body writes (JAX rebinds ``running_mean._value``).
"""
from __future__ import annotations

import torch

from ...ops import apply_like
from ...tensor import Tensor

__all__ = ["normalize", "batch_norm", "layer_norm", "instance_norm",
           "group_norm", "local_response_norm", "rms_norm"]

# the dtype batch norm computes in, whatever its input's (JAX's f32)
_STATS = torch.float32


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def f(v):
        if p == 2:
            n = torch.sqrt(torch.sum(torch.square(v), dim=axis, keepdim=True))
        else:
            n = torch.pow(torch.sum(torch.pow(v.abs(), p), dim=axis,
                                    keepdim=True), 1.0 / p)
        return v / torch.clamp(n, min=epsilon)

    return apply_like(f, "normalize", x)


def _bn_apply(x32, w, b, residual, mean, inv, bshape, act):
    out = (x32 - mean.reshape(bshape)) * inv.reshape(bshape)
    if w is not None:
        out = out * w.reshape(bshape).to(_STATS)
    if b is not None:
        out = out + b.reshape(bshape).to(_STATS)
    if residual is not None:
        out = out + residual.to(_STATS)
    if act == "relu":
        out = torch.relu(out)
    return out


class _BNTrain(torch.autograd.Function):
    """Training batch norm (+ residual, + relu): (out, mean, var), the
    statistics f32 and not differentiated (they feed the running
    statistics only)."""

    @staticmethod
    def forward(ctx, x, w, b, residual, ax, bshape, epsilon, act):
        x32 = x.to(_STATS)
        mean = x32.mean(dim=ax)
        var = torch.square(x32 - mean.reshape(bshape)).mean(dim=ax)
        inv = torch.rsqrt(var + epsilon)
        out = _bn_apply(x32, w, b, residual, mean, inv, bshape,
                        act).to(x.dtype)
        ctx.save_for_backward(x, w, out if act == "relu" else None, mean,
                              inv)
        ctx.meta = (ax, bshape, act, None if residual is None
                    else residual.dtype, None if b is None else b.dtype)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, act_out, mean, inv = ctx.saved_tensors
        ax, bshape, act, res_dtype, b_dtype = ctx.meta
        dy32 = dy.to(_STATS)
        if act == "relu":
            dy32 = torch.where(act_out > 0, dy32, torch.zeros(
                (), dtype=_STATS, device=dy.device))
        xhat = (x.to(_STATS) - mean.reshape(bshape)) * inv.reshape(bshape)
        n = 1
        for a in ax:
            n *= x.shape[a]
        sum_dy = dy32.sum(dim=ax)
        sum_dy_xhat = (dy32 * xhat).sum(dim=ax)
        wf = w.reshape(bshape).to(_STATS) if w is not None else 1.0
        dx = (wf * inv.reshape(bshape)) * (
            dy32 - (sum_dy / n).reshape(bshape)
            - xhat * (sum_dy_xhat / n).reshape(bshape))
        dw = sum_dy_xhat.to(w.dtype) if w is not None else None
        db = sum_dy.to(b_dtype) if b_dtype is not None else None
        dres = dy32.to(res_dtype) if res_dtype is not None else None
        return dx.to(x.dtype), dw, db, dres, None, None, None, None


def _stats_axes(v, chan_last):
    """(reduced axes, broadcast shape of a per-channel vector)."""
    if v.dim() == 2:
        return (0,), (1, -1)
    if chan_last:
        return (tuple(range(v.dim() - 1)), (1,) * (v.dim() - 1) + (-1,))
    return (0,) + tuple(range(2, v.dim())), (1, -1) + (1,) * (v.dim() - 2)


def _raw(t):
    return t._value if isinstance(t, Tensor) else t


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None, residual=None, act=None):
    """Batch statistics in training (the running ones updated in place),
    the running ones otherwise. ``residual`` / ``act="relu"`` (JAX's
    extension): relu(bn(x) + residual) in the same op, its backward
    recomputing the epilogue instead of saving it."""
    if act not in (None, "relu"):
        raise ValueError(f"batch_norm act must be None or 'relu', got "
                         f"{act!r}")
    chan_last = (data_format.endswith("C")
                 and data_format not in ("NC", "NCL"))
    xv = _raw(x)
    ax, bshape = _stats_axes(xv, chan_last)
    if training and not use_global_stats:
        out, mean, var = apply_like(
            lambda v, w, b, r: _BNTrain.apply(v, w, b, r, ax, bshape,
                                              float(epsilon), act),
            "batch_norm", x, weight, bias, residual)
        n = 1
        for a in ax:
            n *= xv.shape[a]
        mean, var = _raw(mean), _raw(var)
        with torch.no_grad():
            for run, stat in ((_raw(running_mean), mean),
                              (_raw(running_var),
                               var * (n / max(n - 1, 1)))):
                if run is not None:
                    run.copy_((momentum * run + (1 - momentum) * stat)
                              .to(run.dtype))
        return out

    def g(v, m, s, w, b, r):
        inv = torch.reciprocal(torch.sqrt(s.to(_STATS) + epsilon))
        return _bn_apply(v.to(_STATS), w, b, r, m.to(_STATS), inv, bshape,
                         act).to(v.dtype)

    return apply_like(g, "batch_norm", x, running_mean, running_var, weight,
                      bias, residual)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Mean and biased variance over the trailing ``normalized_shape`` axes
    in f32, then scale and shift in f32, cast back to x's dtype (the JAX
    package's order of casts). Under AMP O1 the op ``layer_norm`` is
    black-listed: x comes in, and the result goes out, in f32."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_axes = len(list(normalized_shape))

    def f(v, w, b):
        axes = tuple(range(v.dim() - n_axes, v.dim()))
        x32 = v.float()
        mean = x32.mean(dim=axes, keepdim=True)
        var = (x32 - mean).square().mean(dim=axes, keepdim=True)
        out = (x32 - mean) * torch.rsqrt(var + epsilon)
        if w is not None:
            out = out * w.float()
        if b is not None:
            out = out + b.float()
        return out.to(v.dtype)

    return apply_like(f, "layer_norm", x, weight, bias)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """Mean square in f32, normalised value cast back to x's dtype, then
    scaled by ``weight`` (the JAX package's order of casts)."""
    def f(v, w):
        x32 = v.float()
        ms = x32.square().mean(dim=-1, keepdim=True)
        out = (x32 * torch.rsqrt(ms + epsilon)).to(v.dtype)
        return out * w if w is not None else out

    return apply_like(f, "rms_norm", x, weight)


def _chan_last(data_format):
    return data_format.endswith("C") and len(data_format) > 2


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's and channel's own statistics over the spatial axes
    (biased variance), in x's dtype."""
    chan_last = _chan_last(data_format)

    def f(v, w, b):
        if chan_last:
            ax = tuple(range(1, v.dim() - 1))
            bshape = (1,) * (v.dim() - 1) + (-1,)
        else:
            ax = tuple(range(2, v.dim()))
            bshape = (1, -1) + (1,) * (v.dim() - 2)
        mean = v.mean(dim=ax, keepdim=True)
        var = torch.square(v - mean).mean(dim=ax, keepdim=True)
        out = (v - mean) * torch.reciprocal(torch.sqrt(var + eps))
        if w is not None:
            out = out * w.reshape(bshape)
        if b is not None:
            out = out + b.reshape(bshape)
        return out

    return apply_like(f, "instance_norm", x, weight, bias)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    chan_last = _chan_last(data_format)

    def f(v, w, b):
        v_ncx = v.movedim(-1, 1) if chan_last else v
        n, c = v_ncx.shape[0], v_ncx.shape[1]
        g = v_ncx.reshape((n, num_groups, c // num_groups)
                          + tuple(v_ncx.shape[2:]))
        ax = tuple(range(2, g.dim()))
        mean = g.mean(dim=ax, keepdim=True)
        var = torch.square(g - mean).mean(dim=ax, keepdim=True)
        out = ((g - mean) * torch.reciprocal(torch.sqrt(var + epsilon))
               ).reshape(v_ncx.shape)
        bshape = (1, -1) + (1,) * (v_ncx.dim() - 2)
        if w is not None:
            out = out * w.reshape(bshape)
        if b is not None:
            out = out + b.reshape(bshape)
        return out.movedim(1, -1) if chan_last else out

    return apply_like(f, "group_norm", x, weight, bias)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha / size * the sum of squares over ``size`` neighbouring
    channels) ** beta."""
    chan_last = _chan_last(data_format)

    def f(v):
        vv = v.movedim(-1, 1) if chan_last else v
        sq = torch.square(vv)
        c = vv.shape[1]
        half = size // 2
        pads = [0, 0] * (vv.dim() - 2) + [half, size - 1 - half]
        padded = torch.nn.functional.pad(sq, pads)
        acc = sum(padded.narrow(1, i, c) for i in range(size))
        out = vv / torch.pow(k + alpha / size * acc, beta)
        return out.movedim(1, -1) if chan_last else out

    return apply_like(f, "local_response_norm", x)
