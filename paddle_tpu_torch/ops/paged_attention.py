"""Paged split-KV attention and the paged cache writes — the counterpart of
``paddle_tpu/ops/pallas/decode_attention.py``.

Layouts follow the JAX package so the tests compare like with like:
queries ``[B, S, Hq, D]``; page pools head-leading ``[Hkv, P, BS, D]``;
block tables ``[B, NB]`` int32 page ids (entries past a request's extent
must still be valid ids, e.g. 0); ``lengths`` ``[B]`` int32 live prefix per
request. Query row s of request b sits at absolute position
``lengths[b] + s`` and attends to cache columns ``c <= lengths[b] + s``.

* ``paged_decode_attention`` — the wrapper. On CUDA tensors it launches the
  hand-written kernel (``csrc/paged_attention.cu``) or raises; on CPU
  tensors it runs the plain version. ``paged_decode_attention.launches``
  counts kernel launches, so a run can show the main path went through it.
* ``paged_decode_attention_ref`` — the plain PyTorch version: the JAX
  package's gather path (``decode_attention.py:334-340``) followed by
  ``decode_attention_xla`` (``:64``), the port's ``decode_attention_ref``.
* ``paged_cache_update`` / ``write_positions`` — the scatter of new K/V rows
  into the pools (``:385-424``). The JAX code drops padding rows through
  XLA's out-of-bounds scatter (page id ``P``); torch indexing raises on that
  id, so rows past the table's capacity are masked out explicitly before
  the (in-place) scatter.
* ``paged_write_slots`` — the same targets at a fixed length, computed on
  the device with no host synchronisation, for the captured step programs:
  every row gets a target, and a dropped row's is a scratch slot that no
  block table names (``PagedKVCache.scratch_slot``).
"""
from __future__ import annotations

import math

import torch

from . import _build
from .decode_attention import decode_attention_ref
from .decode_attention import kernel_tolerance as dense_tolerance

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "kernel_tolerance", "paged_cache_update", "write_positions",
           "paged_write_index", "paged_write_slots", "paged_scatter_",
           "kernel_launch_config"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = 64          # csrc/paged_attention.cu kRows: query rows of a block
_COLS = 64          # csrc/paged_attention.cu kCols: cache columns of a tile


# ----------------------------------------------------------------- plain
def _gather_dense(pages, block_tables):
    """[Hkv, P, BS, D] pool -> the dense head-leading [B, Hkv, NB*BS, D]
    cache the block tables [B, NB] describe."""
    Hkv, _, BS, D = pages.shape
    B, NB = block_tables.shape
    return (pages[:, block_tables.long()].reshape(Hkv, B, NB * BS, D)
            .transpose(0, 1))


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                               scale=None):
    """Plain PyTorch paged attention: gather the pages into a dense
    head-leading cache, then ``decode_attention_ref`` (grouped-GQA masked
    softmax with f32 scores and probabilities cast to the value dtype
    before P.V)."""
    return decode_attention_ref(q, _gather_dense(k_pages, block_tables),
                                _gather_dense(v_pages, block_tables),
                                lengths, scale)


def kernel_tolerance(q, k_pages, v_pages, block_tables, lengths, ref,
                     scale=None):
    """Elementwise limit on |kernel - plain| for these inputs, where ``ref``
    is ``paged_decode_attention_ref`` of them: the dense kernel's bound
    (``decode_attention.kernel_tolerance``) on the gathered cache. f32
    pools: 1e-4; bf16 pools: 2^-7 (|ref| + sum_j p_j |v_j|) + 1e-5."""
    return dense_tolerance(q, _gather_dense(k_pages, block_tables),
                           _gather_dense(v_pages, block_tables), lengths,
                           ref, scale)


# ---------------------------------------------------------------- kernel
def kernel_launch_config(B, S, G, Hkv, NB, BS, num_sms=132):
    """(row tiles, tiles per split, splits) for one launch.

    A block covers 64 query rows of one (request, kv head) and walks
    64-column cache tiles; the columns are cut into splits so that at
    least 4 blocks per SM exist even at decode, where a (request, kv head)
    has only G query rows, wherever the columns allow that many. Dead splits (past the live prefix) exit without
    reading the tables or K/V. A split spans at most 32 * BS tiles, so the
    page ids it keeps in shared memory stay under ~8 KB."""
    row_tiles = -(-(S * G) // _ROWS)
    num_tiles = -(-(NB * BS) // _COLS)
    target = -(-4 * num_sms // (B * Hkv * row_tiles))
    tiles_per_split = min(max(1, num_tiles // target), 32 * BS)
    splits = -(-num_tiles // tiles_per_split)
    return row_tiles, tiles_per_split, splits


def _launch_kernel(q, k_pages, v_pages, block_tables, lengths, scale):
    B, S, Hq, D = q.shape
    Hkv, P, BS, Dk = k_pages.shape
    NB = block_tables.shape[1]
    dev = q.device
    if k_pages.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16 "
                        f"pools, got {k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages must match in shape and dtype")
    if D not in (64, 128) or Dk != D:
        raise ValueError(f"head_dim {D} unsupported by the kernel (64, 128)")
    if Hq % Hkv != 0:
        raise ValueError(f"num q heads {Hq} not a multiple of kv heads {Hkv}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("block_tables [B, NB] and lengths [B] expected")
    qk = q.to(k_pages.dtype).contiguous()
    if qk.data_ptr() % 16:
        qk = qk.clone()
    G = Hq // Hkv
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, tps, splits = kernel_launch_config(B, S, G, Hkv, NB, BS, sms)
    rows = B * Hkv * S * G
    o_part = torch.empty((splits, rows, D), dtype=torch.float32, device=dev)
    m_part = torch.empty((splits, rows), dtype=torch.float32, device=dev)
    l_part = torch.empty((splits, rows), dtype=torch.float32, device=dev)
    out = torch.empty((B, S, Hq, D), dtype=k_pages.dtype, device=dev)
    lib = _build.load("paged_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.paged_attention_forward(
        qk.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), o_part.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), out.data_ptr(),
        B, S, Hq, Hkv, P, BS, NB, D, _DTYPE_CODE[k_pages.dtype],
        float(scale), tps, splits, stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged attention kernel launch failed: {msg}")
    _build.count_launch(paged_decode_attention, stream)
    return out if out.dtype == q.dtype else out.to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                           scale=None):
    """Attention of ``q`` [B, S, Hq, D] over the paged cache.

    CUDA tensors run the hand-written kernel (queries are cast to the pool
    dtype first, as the TPU kernel does; the output comes back in q's
    dtype). CPU tensors run ``paged_decode_attention_ref``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    return _launch_kernel(q, k_pages, v_pages, block_tables, lengths, scale)


paged_decode_attention.launches = 0


# ----------------------------------------------------------- cache writes
def write_positions(lengths, S, valid=None, capacity=None):
    """[B, S] absolute write positions starting at each request's length;
    rows where ``valid`` is False are pushed to ``capacity`` (= NB*BS) so
    ``paged_cache_update`` drops them."""
    lengths = torch.as_tensor(lengths).reshape(-1).long()
    pos = lengths[:, None] + torch.arange(S, device=lengths.device)[None, :]
    if valid is None:
        return pos
    valid = torch.as_tensor(valid, device=lengths.device).bool()
    return torch.where(valid, pos, torch.full_like(pos, int(capacity)))


def paged_write_index(block_tables, positions, block_size):
    """(rows, slots): flat row indices (b*S + s) of the rows that write, and
    their flat pool targets page*BS + slot. Rows at or past the table's
    capacity NB*BS are left out — the explicit mask that stands in for
    XLA's out-of-bounds-scatter drop. Computed where the inputs lie: built
    on the host, the mask costs the device no synchronisation."""
    tbl = torch.as_tensor(block_tables).long()
    pos = torch.as_tensor(positions).long()
    NB = tbl.shape[1]
    keep = (pos >= 0) & (pos < NB * block_size)
    b_idx, s_idx = keep.nonzero(as_tuple=True)
    p = pos[b_idx, s_idx]
    page = tbl[b_idx, p // block_size]
    rows = b_idx * pos.shape[1] + s_idx
    return rows, page * block_size + p % block_size


def paged_write_slots(block_tables, positions, valid, block_size,
                      scratch_slot):
    """[B*S] flat pool targets page*BS + slot of every row b*S + s, in
    row order, built where the inputs lie with no host synchronisation.
    A row that is not ``valid``, or whose position lies outside
    [0, NB*BS), is aimed at ``scratch_slot``, a slot no block table
    names: the fixed-length form of ``paged_write_index``'s drop."""
    tbl = block_tables.long()
    pos = positions.long()
    NB = tbl.shape[1]
    keep = valid.bool() & (pos >= 0) & (pos < NB * block_size)
    page = tbl.gather(1, (pos // block_size).clamp(0, NB - 1))
    slots = page * block_size + pos % block_size
    return torch.where(keep, slots, torch.full_like(slots, scratch_slot)
                       ).reshape(-1)


def paged_scatter_(pool, new, rows, slots):
    """In place: pool[:, slot] <- new row, for each (row, slot) pair.
    pool [Hkv, P, BS, D] (contiguous); new [B, S, Hkv, D]; ``rows`` None
    means every row in order (``paged_write_slots``' targets)."""
    Hkv, P, BS, D = pool.shape
    vals = new.reshape(-1, Hkv, D)
    if rows is not None:
        vals = vals[rows]
    pool.view(Hkv, P * BS, D)[:, slots] = vals.transpose(0, 1).to(pool.dtype)
    return pool


def paged_cache_update(k_pages, v_pages, k_new, v_new, block_tables,
                       positions):
    """Scatter S new K/V rows per request into the pools, IN PLACE, at
    their (page, slot) targets; rows at positions >= NB*BS are dropped.
    k_new/v_new [B, S, Hkv, D]; positions [B, S]. Returns the pools."""
    rows, slots = paged_write_index(block_tables, positions,
                                    k_pages.shape[2])
    rows = rows.to(k_pages.device)
    slots = slots.to(k_pages.device)
    paged_scatter_(k_pages, k_new, rows, slots)
    paged_scatter_(v_pages, v_new, rows, slots)
    return k_pages, v_pages
