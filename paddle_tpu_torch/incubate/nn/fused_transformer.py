"""Fused transformer layers — the counterpart of
``paddle_tpu/incubate/nn/fused_transformer.py``.

Reference: python/paddle/incubate/nn/layer/fused_transformer.py:213
(FusedMultiHeadAttention), :534 (FusedFeedForward), :750
(FusedTransformerEncoderLayer). As in JAX they are built on the nn layers:
attention goes through ``F.scaled_dot_product_attention``, the plain route
(no flash kernel; ``get_last_attention_backend()`` says "plain"), and the
activation is ``nn.functional``'s function of that name, so ``"gelu"`` is
the exact form here where ``incubate.nn.functional.fused_feedforward``'s is
the tanh one (ROADMAP C). Arguments JAX accepts and never reads (``kdim``,
``vdim``, ``need_weights``, the layer-norm ``*_attr``, ``nranks``,
``ring_id``, ``transpose_qkv_wb``, the encoder layer's ``weight_attr`` /
``bias_attr``, and ``key`` / ``value`` / ``cache`` in ``forward``) raise
when given another value than the default.
"""
from __future__ import annotations

from ...nn import functional as F
from ...nn.layer import Layer
from ...nn.layer_common import Dropout, Linear
from ...nn.layer_conv_norm import LayerNorm
from ...ops.manipulation import unbind

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]


def _unread(what, **given):
    """Raise for each argument JAX accepts and never reads that was given
    a value other than its default (``given``: name -> (value, default))."""
    for name, (value, default) in given.items():
        if value is not default and (default is None or value != default):
            raise NotImplementedError(
                f"{what}({name}={value!r}): the JAX package accepts this "
                f"argument and never reads it")


class FusedMultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, transpose_qkv_wb=False, name=None):
        _unread("FusedMultiHeadAttention", kdim=(kdim, None),
                vdim=(vdim, None), need_weights=(need_weights, False),
                pre_ln_scale_attr=(pre_ln_scale_attr, None),
                pre_ln_bias_attr=(pre_ln_bias_attr, None),
                ln_scale_attr=(ln_scale_attr, None),
                ln_bias_attr=(ln_bias_attr, None), nranks=(nranks, 1),
                ring_id=(ring_id, -1),
                transpose_qkv_wb=(transpose_qkv_wb, False))
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.qkv_proj = Linear(embed_dim, 3 * embed_dim, qkv_weight_attr,
                               qkv_bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, linear_weight_attr,
                               linear_bias_attr)
        self.pre_ln = LayerNorm(embed_dim, epsilon=epsilon)
        self.ln = LayerNorm(embed_dim, epsilon=epsilon)
        self.attn_dropout_rate = attn_dropout_rate
        self.dropout = Dropout(dropout_rate)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        _unread("FusedMultiHeadAttention.forward", key=(key, None),
                value=(value, None), cache=(cache, None))
        residual = query
        x = self.pre_ln(query) if self.normalize_before else query
        qkv = self.qkv_proj(x)
        B, S = qkv.shape[0], qkv.shape[1]
        qkv = qkv.reshape([B, S, 3, self.num_heads, self.head_dim])
        q, k, v = unbind(qkv, axis=2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout_rate,
            training=self.training)
        out = self.out_proj(out.reshape([B, S, self.embed_dim]))
        out = residual + self.dropout(out)
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedFeedForward(Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        _unread("FusedFeedForward", ln1_scale_attr=(ln1_scale_attr, None),
                ln1_bias_attr=(ln1_bias_attr, None),
                ln2_scale_attr=(ln2_scale_attr, None),
                ln2_bias_attr=(ln2_bias_attr, None), nranks=(nranks, 1),
                ring_id=(ring_id, -1))
        super().__init__()
        self.normalize_before = normalize_before
        self.linear1 = Linear(d_model, dim_feedforward, linear1_weight_attr,
                              linear1_bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, linear2_weight_attr,
                              linear2_bias_attr)
        self.ln = LayerNorm(d_model, epsilon=epsilon)
        self.dropout = Dropout(dropout_rate)
        self.act_dropout = Dropout(act_dropout_rate
                                   if act_dropout_rate is not None
                                   else dropout_rate)
        self.activation = getattr(F, activation)

    def forward(self, src, cache=None):
        _unread("FusedFeedForward.forward", cache=(cache, None))
        residual = src
        x = self.ln(src) if self.normalize_before else src
        x = self.linear2(self.act_dropout(self.activation(self.linear1(x))))
        out = residual + self.dropout(x)
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedTransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None):
        _unread("FusedTransformerEncoderLayer",
                weight_attr=(weight_attr, None), bias_attr=(bias_attr, None))
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(attn_dropout_rate
                               if attn_dropout_rate is not None
                               else dropout_rate),
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            act_dropout_rate=act_dropout_rate, activation=activation,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        _unread("FusedTransformerEncoderLayer.forward", cache=(cache, None))
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))
