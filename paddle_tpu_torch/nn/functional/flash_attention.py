"""Attention functionals — the counterpart of
``paddle_tpu/nn/functional/flash_attention.py``. Layout [batch, seq, heads,
head_dim].

``flash_attention`` sends CUDA tensors to the hand-written flash kernels
(``ops/flash_attention.py``) for every shape ``supports`` accepts and raises
on anything else; there is no fallback. The JAX package's TPU crossover (the
Pallas kernel only at S >= 1024, ``_use_pallas`` :70-84) is not copied: the
kernel-against-library times at the training shape are in PERF.md. CPU
tensors run the kernels' plain versions (or ``_sdpa_core`` for shapes the
kernels do not take). ``flashmask_attention`` and ``flash_attn_unpadded``
(packed documents, with one set of boundaries for q and k) run the masked
form of the same kernels. ``sdp_kernel(enable_flash=False)`` switches the
kernels off for all three, as ``_use_pallas`` does in JAX: they then
compute the JAX package's XLA routes in plain PyTorch on any device.
``get_last_attention_backend()`` reports which ran: "kernel" or "plain".
The four functionals take the paddle-style ``Tensor`` as well as a bare
``torch.Tensor`` (``tensor_seam``) and return the kind they were given;
the kernels' ``autograd.Function``s give a Tensor its gradients.

Attention dropout, as in JAX (:108-112), runs on the XLA route's plain
math only: with ``dropout > 0`` in training, ``flash_attention`` and
``flashmask_attention`` take ``_sdpa_core``, which drops probabilities
with a mask from the port's default generator (``keep_mask``); no kernel
has a dropout form. ``flash_attn_unpadded`` raises on dropout in training:
JAX's XLA route there ignores it (ROADMAP C).
"""
from __future__ import annotations

import contextlib
import math

import torch

from ...ops import flash_attention as _fa
from ...tensor import tensor_seam
from .common import keep_mask

__all__ = ["flash_attention", "flash_attn_unpadded", "flashmask_attention",
           "scaled_dot_product_attention", "sdp_kernel",
           "get_last_attention_backend"]

_sdp_config = {"enable_flash": True, "enable_math": True,
               "enable_mem_efficient": True}
_last_backend = {"name": None}


def get_last_attention_backend():
    """"kernel" or "plain": the path that served the last call."""
    return _last_backend["name"]


def _mark(name):
    _last_backend["name"] = name


@contextlib.contextmanager
def sdp_kernel(enable_flash=True, enable_math=True, enable_mem_efficient=True):
    """Within the block, ``enable_flash=False`` keeps the attention
    functionals off the flash kernels (JAX :41-51); the other two flags are
    recorded and read by nothing, as in JAX."""
    prev = dict(_sdp_config)
    _sdp_config.update(enable_flash=enable_flash, enable_math=enable_math,
                       enable_mem_efficient=enable_mem_efficient)
    try:
        yield
    finally:
        _sdp_config.update(prev)


def _takes_kernel(query, key, what):
    """True when the flash kernels' module serves the call: the kernel on
    CUDA, its plain version on CPU. False for the XLA route's plain math:
    sdp_kernel switched the kernels off, or CPU tensors of shapes the
    kernels do not take. Such shapes raise on CUDA."""
    if not _sdp_config["enable_flash"]:
        return False
    if _fa.supports(tuple(query.shape), tuple(key.shape)):
        return True
    if query.device.type != "cpu":
        raise ValueError(
            f"{what}: no kernel for q {tuple(query.shape)}, k "
            f"{tuple(key.shape)} on {query.device} (self-attention "
            f"[B, S, H, D] with kv heads dividing q heads)")
    return False


def _kernel_mark(query):
    _mark("kernel" if query.device.type == "cuda" else "plain")


def _dropped(p, training):
    """True when attention dropout applies to this call."""
    return bool(p) and bool(training)


def _sdpa_core(q, k, v, mask, scale, is_causal, dropout_p, training):
    """q/k/v: [B, S, H, D]; scores in the inputs' dtype, softmax in f32,
    probabilities cast back to q's dtype, then dropped with probability
    ``dropout_p`` in training (kept ones scaled by 1 / (1 - p), in q's
    dtype) (JAX ``_sdpa_core`` :87-114)."""
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
    if _dropped(dropout_p, training):
        keep = keep_mask(probs.shape, 1.0 - dropout_p, probs.device)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    out = torch.einsum("bhst,bhtd->bhsd", probs, vh)
    return out.transpose(1, 2)


@tensor_seam
def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """Reference: flash_attention.py:358. Returns ``(out, None)``. With
    dropout in training the call is the plain route's, as in JAX."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    if (not _dropped(dropout, training)
            and _takes_kernel(query, key, "flash_attention")):
        _kernel_mark(query)
        return _fa.flash_attention(query, key, value, causal=causal,
                                   scale=scale), None
    _mark("plain")
    return _sdpa_core(query, key, value, None, scale, causal, dropout,
                      training), None


@tensor_seam
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Plain math over [B, S, H, D], as the JAX package has it (no kernel;
    reported as "plain")."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    _mark("plain")
    return _sdpa_core(query, key, value, attn_mask, scale, is_causal,
                      dropout_p, training)


def _same_cu(cu_q, cu_k):
    """True iff the q and k document boundaries are the same (JAX :54-67):
    the masked kernel masks by k's documents only. Compares the values, one
    host sync on CUDA, unless both are the one object."""
    if cu_q is cu_k:
        return True
    a, b = torch.as_tensor(cu_q).long(), torch.as_tensor(cu_k).long()
    return a.shape == b.shape and bool(torch.equal(a, b.to(a.device)))


def _segments(cu, total):
    """Each packed token's document index under the int64 boundaries cu:
    the count of inner boundaries at or before it (JAX's cumsum of
    boundary marks, :171-173)."""
    return torch.searchsorted(cu[1:-1], torch.arange(total, device=cu.device),
                              right=True)


def _document_mask(cu, total, causal):
    """The FlashMask of packed documents (JAX :170-194), built on cu's
    device: per key column its document's [start, end) from the
    boundaries; causal masks rows >= end (n = 1), non-causal rows outside
    [start, end) (``[end, total, 0, start]``). [1, 1, total, n]."""
    cu = cu.long()
    seg = _segments(cu, total)
    end, start = cu[seg + 1], cu[seg]
    if causal:
        return end[None, None, :, None]
    return torch.stack([end, torch.full_like(end, total),
                        torch.zeros_like(end), start], -1)[None, None]


def _segment_attention(q, k, v, cu_q, cu_k, scale, causal):
    """The XLA route of ``flash_attn_unpadded`` (JAX :204-226): scores in
    the inputs' dtype over [total_q, total_k], kept where the q and k
    segments agree (and, causal, the position within the document allows),
    softmax in f32, probabilities cast back to q's dtype."""
    cu_q, cu_k = cu_q.long(), cu_k.long()
    seg_q, seg_k = _segments(cu_q, q.shape[0]), _segments(cu_k, k.shape[0])
    scores = torch.einsum("qhd,khd->hqk", q, k) * scale
    keep = seg_q[:, None] == seg_k[None, :]
    if causal:
        pos_q = torch.arange(q.shape[0], device=q.device) - cu_q[seg_q]
        pos_k = torch.arange(k.shape[0], device=k.device) - cu_k[seg_k]
        keep = keep & (pos_q[:, None] >= pos_k[None, :])
    fill = torch.full((), torch.finfo(scores.dtype).min, dtype=scores.dtype,
                      device=scores.device)
    scores = torch.where(keep[None], scores, fill)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", probs, v)


@tensor_seam
def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen attention (reference :756, JAX :141-226): documents packed as
    [total, heads, head_dim] with ``cu_seqlens`` boundaries. Returns
    ``(out, None)``.

    With one set of boundaries for q and k, the packed row is one batch of
    ``[1, total, H, D]`` through the masked flash kernels, under the
    document FlashMask built from ``cu_seqlens_k`` on the device
    (``_document_mask``); the kernels take any total, so nothing is padded
    (JAX pads to its 128-row block). Different boundaries take the XLA
    route's segment mask in plain PyTorch on any device, reported as
    "plain". Dropout in training raises: JAX's XLA route accepts it and
    ignores it (ROADMAP C), and the port does not copy a silent no-op."""
    if _dropped(dropout, training):
        raise NotImplementedError(
            "flash_attn_unpadded: dropout is not ported (the JAX package's "
            "route for packed documents ignores it; ROADMAP C)")
    total = int(query.shape[0])
    cu_k = torch.as_tensor(cu_seqlens_k).to(query.device)
    q, k, v = query[None], key[None], value[None]
    if (key.shape[0] == total and _same_cu(cu_seqlens_q, cu_seqlens_k)
            and _takes_kernel(q, k, "flash_attn_unpadded")):
        _kernel_mark(query)
        out = _fa.flashmask_attention(q, k, v,
                                      _document_mask(cu_k, total, causal),
                                      causal=causal, scale=scale)
        return out[0], None
    _mark("plain")
    cu_q = torch.as_tensor(cu_seqlens_q).to(query.device)
    return _segment_attention(query, key, value, cu_q, cu_k, scale,
                              causal), None


@tensor_seam
def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Reference: flash_attention.py:1299 (JAX :229-298).
    ``startend_row_indices`` [B, H' in {1, H}, S, n in {1, 2, 4}]: per key
    column the query rows it hides (``ops.flash_attention.
    flashmask_allowed``), evaluated inside the masked kernel. Without it,
    the call is ``flash_attention``'s. A row with no allowed column gives 0
    (the kernel's contract, JAX's Pallas kernel too; JAX's XLA route gives
    the mean of V there). With dropout in training the call is the plain
    route's (JAX :253-292). ``return_softmax_lse`` / ``return_seed_offset``
    add ``None`` per flag, as in JAX."""
    if window_size is not None:
        raise NotImplementedError(
            "flashmask_attention: window_size is not ported (the JAX "
            "package accepts it and never reads it)")
    scale = 1.0 / math.sqrt(query.shape[-1])
    sri = startend_row_indices
    if sri is None:
        out, _ = flash_attention(query, key, value, dropout=dropout,
                                 causal=causal, training=training)
    elif (not _dropped(dropout, training)
          and _takes_kernel(query, key, "flashmask_attention")):
        _kernel_mark(query)
        out = _fa.flashmask_attention(query, key, value, sri, causal=causal,
                                      scale=scale)
    else:
        _mark("plain")
        sri = torch.as_tensor(sri).to(query.device)
        out = _sdpa_core(query, key, value,
                         _fa.flashmask_allowed(query.shape[1], sri, causal),
                         scale, False, dropout, training)
    extras = [None] * (int(return_softmax_lse) + int(return_seed_offset))
    return (out, *extras) if extras else out
