"""RoPE, SwiGLU and the fused functionals — the counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py:17-179``.

RoPE is the neox style (rotate halves) over the layout
[batch, seq, heads, head_dim], at per-row absolute positions [B, S]; the
frequencies are built in f32 and the sin/cos tables cast to the
activations' dtype before the rotation, as in the JAX package.
``fused_linear``, ``fused_bias_act``, ``fused_rms_norm``,
``fused_layer_norm`` and ``fused_dropout_add`` are JAX's formulas in
plain torch (XLA fuses them there; no kernel stands behind them), each
through ``ops.apply_like`` under JAX's op name, so AMP casts them as JAX
does and they return the kind they are given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ....amp import _amp_cast
from ....ops import apply_like

__all__ = ["rope_cos_sin", "apply_rope", "swiglu", "fused_linear",
           "fused_bias_act", "fused_rms_norm", "fused_layer_norm",
           "fused_dropout_add"]


def swiglu(x, y=None, name=None):
    """silu(a) * b, with (a, b) the two halves of x's last axis (or x, y)."""
    def f(a, b):
        if b is None:
            a, b = a.chunk(2, dim=-1)
        return F.silu(a) * b

    return apply_like(f, "swiglu", x, y)


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
    (t,) = _amp_cast("fused_rope", t)
    half = t.shape[-1] // 2
    rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    return t * cos.to(t.dtype) + rot * sin.to(t.dtype)


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ W (+ b); W [in, out], or [out, in] with ``transpose_weight``."""
    def f(v, w, b):
        out = v @ (w.T if transpose_weight else w)
        return out + b if b is not None else out

    return apply_like(f, "fused_linear", x, weight, bias)


def fused_bias_act(x, bias=None, dequant_scales=None, shift=None,
                   smooth=None, act_method="gelu", compute_dtype="default",
                   quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                   quant_min_bound=0):
    """act(x + bias): ``gelu`` (the tanh form, as JAX's), ``swiglu`` over the halves of the
    last axis, or ``torch.nn.functional``'s function of that name
    (``relu``, ``silu``, ``sigmoid``, ...). The quantisation arguments are not read, as in
    JAX."""
    def f(v, b):
        if b is not None:
            v = v + b
        if act_method == "gelu":    # jax.nn.gelu's default: tanh form
            return F.gelu(v, approximate="tanh")
        if act_method == "swiglu":
            a, g = v.chunk(2, dim=-1)
            return F.silu(a) * g
        return getattr(F, act_method)(v)

    return apply_like(f, "fused_bias_act", x, bias)


def _pre_norm(v, extra_bias, res):
    if extra_bias is not None:
        v = v + extra_bias
    return v + res if res is not None else v


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                   quant_min_bound=0):
    """RMS norm of (x + bias + residual) over the last axis in f32, cast
    back, times the weight (plus ``norm_bias``)."""
    def f(v, w, b, extra_bias, res):
        v = _pre_norm(v, extra_bias, res)
        v32 = v.float()
        ms = v32.square().mean(-1, keepdim=True)
        out = (v32 * torch.rsqrt(ms + epsilon)).to(v.dtype) * w
        return out + b if b is not None else out

    return apply_like(f, "fused_rms_norm", x, norm_weight, norm_bias, bias,
                      residual)


def fused_layer_norm(x, norm_weight, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None, **kw):
    """Layer norm of (x + bias + residual) over the last axis, in the
    input's dtype as JAX computes it."""
    def f(v, w, b, extra_bias, res):
        v = _pre_norm(v, extra_bias, res)
        mean = v.mean(-1, keepdim=True)
        var = (v - mean).square().mean(-1, keepdim=True)
        out = (v - mean) * torch.rsqrt(var + epsilon)
        if w is not None:
            out = out * w
        return out + b if b is not None else out

    return apply_like(f, "fused_layer_norm", x, norm_weight, norm_bias,
                      bias, residual)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """dropout(x) + y, the mask drawn from the port's default generator on
    x's device (``nn.functional.keep_mask``)."""
    from ....nn.functional.common import keep_mask

    def f(xv, yv):
        if not training or p == 0.0:
            return xv + yv
        keep = keep_mask(xv.shape, 1.0 - p, xv.device)
        kept = xv / (1.0 - p) if mode == "upscale_in_train" else xv
        zero = torch.zeros((), dtype=xv.dtype, device=xv.device)
        return torch.where(keep, kept, zero).to(xv.dtype) + yv

    return apply_like(f, "fused_dropout_add", x, y)
