"""RoPE, SwiGLU and the fused functionals — the counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``.

RoPE is the neox style (rotate halves) over the layout
[batch, seq, heads, head_dim], at per-row absolute positions [B, S]; the
frequencies are built in f32 and the sin/cos tables cast to the
activations' dtype before the rotation, as in the JAX package.
``fused_linear``, ``fused_bias_act``, ``fused_rms_norm``,
``fused_layer_norm`` and ``fused_dropout_add`` are JAX's formulas in
plain torch (XLA fuses them there; no kernel stands behind them), each
through ``ops.apply_like`` under JAX's op name, so AMP casts them as JAX
does and they return the kind they are given.

``fused_rotary_position_embedding`` (neox and interleaved styles; tables
built per row from ``position_ids``, or given), ``fused_multi_head_attention``
(pre- or post-LN, both qkv weight layouts, the plain attention core
``_sdpa_core`` with mask and attention dropout, residual) and
``fused_feedforward`` are JAX's single traced ops (:54-125, :182-314), each
one ``apply_like`` here. As in JAX, they attend on the plain route (no
flash kernel) and ``fused_feedforward``'s ``gelu`` is the tanh form, where
the layer ``FusedFeedForward``'s is the exact one (ROADMAP C).
``cache_kv`` raises as in JAX; a ``ring_id`` other than -1 raises (JAX
accepts it and reads nothing).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ....amp import _amp_cast
from ....ops import apply_like

__all__ = ["rope_cos_sin", "apply_rope", "swiglu", "fused_linear",
           "fused_bias_act", "fused_rms_norm", "fused_layer_norm",
           "fused_dropout_add", "fused_rotary_position_embedding",
           "fused_multi_head_attention", "fused_feedforward"]


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


def _rotate(t, cos, sin, neox=True):
    """t * cos + rotate(t) * sin: rotate the halves (neox) or the
    interleaved pairs."""
    if neox:
        half = t.shape[-1] // 2
        rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    else:
        rot = torch.stack([-t[..., 1::2], t[..., 0::2]], dim=-1).reshape(
            t.shape)
    return t * cos + rot * sin


def apply_rope(t, cos, sin, *more):
    """The rotation of t (and of each tensor in ``more``: q and k pass
    through one ``fused_rope`` seam, as JAX rotates them in one op), with
    the tables cast to t's dtype (JAX casts them to q's,
    ``fused_rotary_position_embedding``: under AMP O1 q and k come from a
    white-listed linear in the amp dtype). Returns the rotated t, or a
    tuple with ``more``."""
    ts = _amp_cast("fused_rope", t, *more)
    out = tuple(_rotate(x, cos.to(x.dtype), sin.to(x.dtype)) for x in ts)
    return out if more else out[0]


def _rope_tables(S, D, pos, neox, base, device):
    """cos, sin in f32 (JAX :74-97): per row at ``pos`` [B, S] as
    ``rope_cos_sin`` builds them (neox), or at 0..S-1 -> [1, S, 1, D]."""
    if pos is not None and neox:
        return rope_cos_sin(pos, D, torch.float32, base)
    inv = 1.0 / (base ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=device) / D))
    seq = (pos.float() if pos is not None
           else torch.arange(S, dtype=torch.float32, device=device))
    freqs = seq[..., None] * inv
    emb = (torch.cat([freqs, freqs], dim=-1) if neox
           else freqs.repeat_interleave(2, dim=-1))
    emb = emb[None, :, None, :] if emb.ndim == 2 else emb[:, :, None, :]
    return emb.cos(), emb.sin()


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """RoPE over q (and k, v) [batch, seq, heads, head_dim] (reference
    fused_rope): tables from ``position_ids`` [B, S] per row, or at
    0..S-1, or the given ``sin`` / ``cos`` ([S, D] or [1, S, 1, D], rows
    taken at ``position_ids`` when given); cast to q's dtype. Returns
    (q', k', v') with None for inputs not given."""
    if time_major:
        raise NotImplementedError(
            "fused_rotary_position_embedding(time_major=True): the JAX "
            "package reads the [batch, seq, ...] layout only")

    def f(qv, kv, vv, sin_v, cos_v, pos):
        S, D = qv.shape[1], qv.shape[-1]
        if sin_v is None:
            cos_v, sin_v = _rope_tables(S, D, pos, use_neox_rotary_style,
                                        rotary_emb_base, qv.device)
        else:
            if sin_v.ndim == 2:
                sin_v, cos_v = sin_v[None, :, None, :], cos_v[None, :, None, :]
            if pos is not None:
                idx = pos.long()
                sin_v = sin_v[0, :, 0][idx][:, :, None, :]
                cos_v = cos_v[0, :, 0][idx][:, :, None, :]
        sin_v, cos_v = sin_v.to(qv.dtype), cos_v.to(qv.dtype)
        outs = tuple(_rotate(t, cos_v, sin_v, use_neox_rotary_style)
                     for t in (qv, kv, vv) if t is not None)
        return outs if len(outs) > 1 else outs[0]

    out = apply_like(f, "fused_rope", q, k, v, sin, cos, position_ids)
    if not isinstance(out, tuple):
        return out, None, None
    res = list(out) + [None] * (3 - len(out))
    return tuple(res[:3])


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
        return _ln(_pre_norm(v, extra_bias, res), w, b, epsilon)

    return apply_like(f, "fused_layer_norm", x, norm_weight, norm_bias,
                      bias, residual)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """dropout(x) + y, the mask drawn from the port's default generator on
    x's device (``nn.functional.keep_mask``)."""
    return apply_like(lambda xv, yv: _drop(xv, p, training, mode) + yv,
                      "fused_dropout_add", x, y)


def _ln(h, scale, bias, eps):
    """Layer norm over the last axis in h's dtype (JAX's mean / var /
    rsqrt), then scale and bias."""
    mean = h.mean(-1, keepdim=True)
    var = (h - mean).square().mean(-1, keepdim=True)
    h = (h - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        h = h * scale
    return h + bias if bias is not None else h


def _drop(h, rate, training, mode):
    """Dropout of h at ``rate``, the mask from the device's default
    generator (``nn.functional.keep_mask``)."""
    from ....nn.functional.common import keep_mask

    if not rate or not training:
        return h
    keep = keep_mask(h.shape, 1.0 - rate, h.device)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    kept = h / (1.0 - rate) if mode == "upscale_in_train" else h
    return torch.where(keep, kept, zero).to(h.dtype)


def _no_ring(ring_id, what):
    if ring_id != -1:
        raise NotImplementedError(
            f"{what}(ring_id={ring_id}): the JAX package accepts the "
            f"argument and reads nothing; the port raises rather than "
            f"ignore it (ROADMAP C)")


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.0,
                               attn_dropout_rate=0.0, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=None,
                               transpose_qkv_wb=False, name=None):
    """The whole attention block as one op (JAX :182-259): [pre-LN ->]
    qkv -> attention (``_sdpa_core``: additive or bool mask, attention
    dropout) -> out-projection -> hidden dropout -> [residual ->]
    [post-LN]. ``qkv_weight``: [3, num_heads, head_dim, embed], or with
    ``transpose_qkv_wb`` [embed, 3 * embed] (``num_heads`` given)."""
    if cache_kv is not None:
        raise NotImplementedError(
            "cache_kv incremental decode is not supported here; use "
            "GPTForCausalLM.generate-style per-layer caches")
    _no_ring(ring_id, "fused_multi_head_attention")
    from ....nn.functional.flash_attention import _mark, _sdpa_core

    def f(xv, qkv_w, qkv_b, lin_w, lin_b, pre_s, pre_b, post_s, post_b,
          mask):
        B, S, E = xv.shape
        h = _ln(xv, pre_s, pre_b, pre_ln_epsilon) if pre_layer_norm else xv
        if transpose_qkv_wb:
            qkv = h @ qkv_w
            if qkv_b is not None:
                qkv = qkv + qkv_b
            qkv = qkv.reshape(B, S, 3, num_heads, E // num_heads)
        else:
            qkv = torch.einsum("bse,thde->bsthd", h, qkv_w)
            if qkv_b is not None:
                qkv = qkv + qkv_b[None, None]
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        _mark("plain")
        ctx = _sdpa_core(q, k, v, mask, 1.0 / math.sqrt(q.shape[-1]), False,
                         attn_dropout_rate, training).reshape(B, S, -1)
        out = ctx @ lin_w
        if lin_b is not None:
            out = out + lin_b
        out = _drop(out, dropout_rate, training, mode)
        if add_residual:
            out = xv + out
        if not pre_layer_norm:
            out = _ln(out, post_s, post_b, ln_epsilon)
        return out

    return apply_like(f, "fused_multi_head_attention", x, qkv_weight,
                      qkv_bias, linear_weight, linear_bias, pre_ln_scale,
                      pre_ln_bias, ln_scale, ln_bias, attn_mask)


_FFN_ACTS = {"relu": F.relu, "silu": F.silu,
             # jax.nn.gelu's default: the tanh form
             "gelu": lambda h: F.gelu(h, approximate="tanh")}


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, name=None):
    """The FFN block as one op (JAX :262-314): [pre-LN ->] linear1 ->
    act (relu, silu, or gelu's tanh form) -> dropout1 -> linear2 ->
    dropout2 -> residual [-> post-LN]."""
    _no_ring(ring_id, "fused_feedforward")
    act = _FFN_ACTS[activation]

    def f(xv, w1, b1, w2, b2, s1, bb1, s2, bb2):
        h = _ln(xv, s1, bb1, ln1_epsilon) if pre_layer_norm else xv
        h = h @ w1
        if b1 is not None:
            h = h + b1
        h = _drop(act(h), dropout1_rate, training, mode) @ w2
        if b2 is not None:
            h = h + b2
        out = xv + _drop(h, dropout2_rate, training, mode)
        if not pre_layer_norm:
            out = _ln(out, s2, bb2, ln2_epsilon)
        return out

    return apply_like(f, "fused_feedforward", x, linear1_weight,
                      linear1_bias, linear2_weight, linear2_bias, ln1_scale,
                      ln1_bias, ln2_scale, ln2_bias)
