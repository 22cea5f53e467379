"""Dense split-KV attention — the counterpart of
``paddle_tpu/ops/pallas/decode_attention.py:64-252``.

Layouts follow the JAX package so the tests compare like with like:
queries ``[B, S, Hq, D]`` at absolute positions ``lengths[b] + s``; caches
head-leading ``[B, Hkv, T, D]`` whose rows ``[0, lengths[b] + S)`` are live
(the S new rows were just written at ``[lengths[b], lengths[b] + S)``);
``lengths`` an int or an int32 ``[B]`` tensor. Query row s of request b
attends to cache columns ``c <= lengths[b] + s``.

* ``decode_attention`` — the wrapper. On CUDA tensors it launches the
  hand-written kernel (``csrc/decode_attention.cu``) or raises; on CPU
  tensors it runs the plain version. ``decode_attention.launches`` counts
  calls that launched the kernel, so a run can show the main path went
  through it. Unlike the JAX wrapper, it never drops to the plain version
  for a cache length its blocks do not divide: the kernel masks the ragged
  tail itself.
* ``kernel_launch_config`` — which of the kernel's two forms a call takes
  (decode: 16-row blocks on ``mma.sync`` with K/V in flight through a
  ring, for up to 16 query rows per (request, kv head) and for f32;
  prefill: 64-row ``wgmma`` blocks, bf16) and how its cache tiles are
  split across blocks.
* ``decode_attention_ref`` — the plain PyTorch version, the JAX package's
  ``decode_attention_xla`` (``:64-92``): grouped einsum (K/V never
  repeated), f32 scores, probabilities cast to the cache dtype before P.V.
* ``kernel_tolerance`` — the elementwise limit a kernel is held to against
  the plain version; the paged kernel's limit is the same bound.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build

__all__ = ["decode_attention", "decode_attention_ref", "kernel_tolerance",
           "kernel_launch_config", "LaunchConfig"]

_NEG = torch.finfo(torch.float32).min
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = 64          # prefill form: query rows of a block (kRows)
_DECODE_ROWS = 16   # decode form: query rows of a block (kDecRows)
_COLS = 64          # cache columns of a tile (kCols)
# tiles a split streams at least: a bf16 split costs a combine against
# bandwidth a block already has; f32 products are compute-bound on the
# CUDA cores, so f32 calls split as far as one block per SM allows
_MIN_TILES = {torch.bfloat16: 8, torch.float32: 1}
_FORMS = {"decode": 0, "prefill": 1}


def _norm_lengths(lengths, B, device):
    """int or [B] / scalar tensor -> [B] tensor on ``device``."""
    if isinstance(lengths, torch.Tensor):
        return lengths.to(device).reshape(-1).expand(B)
    return torch.full((B,), int(lengths), dtype=torch.int32, device=device)


# ----------------------------------------------------------------- plain
def decode_attention_ref(q, k_cache, v_cache, lengths, scale=None):
    """Plain PyTorch dense-cache attention: grouped-GQA masked softmax with
    f32 scores and probabilities cast to the value dtype before P.V."""
    B, S, Hq, D = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    lengths = _norm_lengths(lengths, B, q.device).long()
    qg = q.reshape(B, S, Hkv, G, D)
    scores = torch.einsum("bsngd,bntd->bngst", qg.float(),
                          k_cache.float()) * scale
    pos_q = lengths[:, None] + torch.arange(S, device=q.device)[None, :]
    pos_k = torch.arange(T, device=q.device)
    allowed = pos_k[None, None, :] <= pos_q[:, :, None]          # [B, S, T]
    scores = torch.where(allowed[:, None, None], scores,
                         torch.full((), _NEG, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bngst,bntd->bsngd", probs, v_cache)
    return out.reshape(B, S, Hq, D).to(q.dtype)


def kernel_tolerance(q, k_cache, v_cache, lengths, ref, scale=None):
    """Elementwise limit on |kernel - plain| for these inputs, where ``ref``
    is ``decode_attention_ref`` of them.

    f32 caches: 1e-4, another summation order over up to a few thousand
    columns. bf16 caches: each side rounds every probability (the kernel
    its unnormalised p, the plain version the normalised one) and the
    output to bf16, unit roundoff 2^-8, so the two differ by at most
    2^-7 (|ref| + sum_j p_j |v_j|), plus 1e-5 of f32 accumulation noise."""
    if k_cache.dtype == torch.float32:
        return torch.full(ref.shape, 1e-4, device=ref.device)
    mag = decode_attention_ref(q.float(), k_cache.float(),
                               v_cache.float().abs(), lengths, scale)
    return 1e-5 + 2.0 ** -7 * (ref.float().abs() + mag)


# ---------------------------------------------------------------- kernel
class LaunchConfig(NamedTuple):
    """How one call runs: the form (``"decode"``: 16-row blocks of
    mma.sync; ``"prefill"``: 64-row wgmma blocks, bf16 only), the query
    rows a block owns, and the cache tiles of 64 columns cut into
    ``splits`` pieces of ``tiles_per_split``."""
    form: str
    rows: int
    tiles_per_split: int
    splits: int


def kernel_launch_config(B, S, G, Hkv, T, dtype=torch.bfloat16,
                         num_sms=132):
    """The form and the split of one launch.

    bf16 calls with more than 16 query rows per (request, kv head) take the
    prefill form (64-row blocks); every other call the decode form (16-row
    blocks). The cache tiles are split only as far as one block per SM and
    ``_MIN_TILES`` tiles per split allow: a block keeps several tiles in
    flight through its ring, and a split costs a combine. generate()'s
    prefill and decode (8 requests of 16 heads) run unsplit, so their
    blocks write the output directly. Splits past a request's live prefix
    exit without reading K/V."""
    form = ("prefill" if dtype == torch.bfloat16 and S * G > _DECODE_ROWS
            else "decode")
    rows = _ROWS if form == "prefill" else _DECODE_ROWS
    blocks = B * Hkv * -(-(S * G) // rows)
    num_tiles = -(-T // _COLS)
    target = max(1, min(num_sms // blocks, num_tiles // _MIN_TILES[dtype]))
    tiles_per_split = -(-num_tiles // target)
    splits = -(-num_tiles // tiles_per_split)
    return LaunchConfig(form, rows, tiles_per_split, splits)


def _launch_kernel(q, k_cache, v_cache, lengths, scale):
    """Launch the kernel on CUDA tensors. A call of several splits writes
    f32 partials that a second launch combines."""
    B, S, Hq, D = q.shape
    dev = q.device
    if k_cache.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode attention kernel takes float32 or bfloat16 "
                        f"caches, got {k_cache.dtype}")
    if v_cache.dtype != k_cache.dtype or v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache must match in shape and dtype")
    if k_cache.dim() != 4 or k_cache.shape[0] != B:
        raise ValueError(f"caches [B={B}, Hkv, T, D] expected, got "
                         f"{tuple(k_cache.shape)}")
    _, Hkv, T, Dk = k_cache.shape
    if D not in (64, 128) or Dk != D:
        raise ValueError(f"head_dim {D} unsupported by the kernel (64, 128)")
    if Hq % Hkv != 0:
        raise ValueError(f"num q heads {Hq} not a multiple of kv heads {Hkv}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if isinstance(t, torch.Tensor) and t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if isinstance(lengths, torch.Tensor):
        if lengths.dtype != torch.int32:
            raise TypeError("lengths must be an int or an int32 tensor")
        if lengths.numel() not in (1, B):
            raise ValueError(f"lengths: {lengths.numel()} values for B={B}")
        lengths = _norm_lengths(lengths, B, dev).contiguous()
        lens_ptr, uniform = lengths.data_ptr(), 0
    else:           # one length for the batch: no device tensor to build
        uniform = int(lengths)
        if uniform < 0:
            raise ValueError(f"lengths must be >= 0, got {uniform}")
        lens_ptr = None
    qk = q.to(k_cache.dtype).contiguous()
    if qk.data_ptr() % 16:
        qk = qk.clone()
    G = Hq // Hkv
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = kernel_launch_config(B, S, G, Hkv, T, k_cache.dtype, sms)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((B, S, Hq, D), dtype=k_cache.dtype, device=dev)
    o_part = m_part = l_part = None   # one split: out directly
    if cfg.splits > 1:
        rows = B * Hkv * S * G
        o_part = torch.empty((cfg.splits, rows, D), dtype=torch.float32,
                             device=dev)
        m_part, l_part = torch.empty((2, cfg.splits, rows),
                                     dtype=torch.float32, device=dev)
    lib = _build.load("decode_attention")
    err = lib.decode_attention_forward(
        qk.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens_ptr,
        uniform, *(None if t is None else t.data_ptr()
                   for t in (o_part, m_part, l_part)),
        out.data_ptr(), B, S, Hq, Hkv, T, D,
        _DTYPE_CODE[k_cache.dtype], float(scale), _FORMS[cfg.form],
        cfg.tiles_per_split, cfg.splits, stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode attention kernel launch failed: {msg}")
    _build.count_launch(decode_attention, stream)
    return out if out.dtype == q.dtype else out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, scale=None):
    """Attention of ``q`` [B, S, Hq, D] over the dense head-leading caches
    [B, Hkv, T, D] with live prefix ``lengths`` (int or int32 [B]).

    CUDA tensors run the hand-written kernel (queries are cast to the cache
    dtype first, as the TPU kernel does; the output comes back in q's
    dtype). CPU tensors run ``decode_attention_ref``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    return _launch_kernel(q, k_cache, v_cache, lengths, scale)


decode_attention.launches = 0
