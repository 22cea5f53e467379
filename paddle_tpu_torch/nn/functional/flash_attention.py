"""Attention functionals — the counterpart of
``paddle_tpu/nn/functional/flash_attention.py``. Layout [batch, seq, heads,
head_dim].

``flash_attention`` sends CUDA tensors to the hand-written flash kernels
(``ops/flash_attention.py``) for every shape ``supports`` accepts and raises
on anything else; there is no fallback. The JAX package's TPU crossover (the
Pallas kernel only at S >= 1024, ``_use_pallas`` :70-84) is not copied: the
kernel-against-library times at the training shape are in PERF.md. CPU
tensors run the kernels' plain versions (or ``_sdpa_core`` for shapes the
kernels do not take). ``get_last_attention_backend()`` reports which ran:
"kernel" or "plain".

Dropout is not ported: the JAX package draws its mask from ``jax.random``
on the XLA path, which the port cannot replay, so ``dropout > 0`` raises.
"""
from __future__ import annotations

import math

import torch

from ...ops import flash_attention as _fa

__all__ = ["flash_attention", "flash_attn_unpadded", "flashmask_attention",
           "scaled_dot_product_attention", "get_last_attention_backend"]

_last_backend = {"name": None}


def get_last_attention_backend():
    """"kernel" or "plain": the path that served the last call."""
    return _last_backend["name"]


def _mark(name):
    _last_backend["name"] = name


def _no_dropout(p, training):
    if p and training:
        raise NotImplementedError(
            "attention dropout is not ported: the JAX package draws its "
            "mask from jax.random, which the port cannot replay")


def _sdpa_core(q, k, v, mask, scale, is_causal, dropout_p, training):
    """q/k/v: [B, S, H, D]; scores in the inputs' dtype, softmax in f32,
    probabilities cast back to q's dtype (JAX ``_sdpa_core`` :87-114)."""
    _no_dropout(dropout_p, training)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", qh, kh) * scale
    fill = torch.full((), torch.finfo(scores.dtype).min, dtype=scores.dtype,
                      device=scores.device)
    if is_causal:
        s, t = scores.shape[-2], scores.shape[-1]
        causal = torch.ones((s, t), dtype=torch.bool,
                            device=scores.device).tril(t - s)
        scores = torch.where(causal, scores, fill)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = torch.where(mask, scores, fill)
        else:
            scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bhtd->bhsd", probs, vh)
    return out.transpose(1, 2)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """Reference: flash_attention.py:358. Returns ``(out, None)``."""
    _no_dropout(dropout, training)
    scale = 1.0 / math.sqrt(query.shape[-1])
    if _fa.supports(tuple(query.shape), tuple(key.shape)):
        _mark("kernel" if query.device.type == "cuda" else "plain")
        return _fa.flash_attention(query, key, value, causal=causal,
                                   scale=scale), None
    if query.device.type != "cpu":
        raise ValueError(
            f"flash_attention: no kernel for q {tuple(query.shape)}, k "
            f"{tuple(key.shape)} on {query.device} (self-attention "
            f"[B, S, H, D] with kv heads dividing q heads)")
    _mark("plain")
    return _sdpa_core(query, key, value, None, scale, causal, dropout,
                      training), None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Plain math over [B, S, H, D], as the JAX package has it (no kernel)."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    return _sdpa_core(query, key, value, attn_mask, scale, is_causal,
                      dropout_p, training)


def flashmask_attention(*args, **kwargs):
    raise NotImplementedError(
        "flashmask_attention is not ported yet: it needs the FlashMask form "
        "of the flash kernels (ROADMAP B6)")


def flash_attn_unpadded(*args, **kwargs):
    raise NotImplementedError(
        "flash_attn_unpadded is not ported yet: the packed varlen path runs "
        "on the FlashMask form of the flash kernels (ROADMAP B6)")
