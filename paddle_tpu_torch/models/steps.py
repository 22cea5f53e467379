"""What the cache branches of every decoder share: the per-forward step
contexts (``PagedStep``, ``DenseStep``), the positions they give each new
row, and the cached attention — the new K/V rows written into the paged
pools or dense caches in place, then attention over the live prefix.
``GPTAttention`` and ``LlamaAttention`` pass in the attention functions
they chose by ``decode_kernel`` (the kernel wrappers or their plain
versions, looked up in their own module, where the in-situ checks rebind
them)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..amp import _amp_cast
from ..ops.paged_attention import paged_scatter_

__all__ = ["PagedStep", "DenseStep", "DECODE_KERNELS", "step_positions",
           "attend_cached", "kernel_serves"]

DECODE_KERNELS = ("kernel", "plain")
KERNEL_HEAD_DIMS = (64, 128)    # what the paged and dense kernels take


def kernel_serves(decode_kernel, q):
    """True when the cache branch calls the kernel wrappers: asked for
    (``decode_kernel="kernel"``), and on CUDA at a head dim the kernels
    take. Other head dims on CUDA take the plain versions (``*_ref``),
    chosen before any launch, as JAX computes every head dim; on the CPU
    the wrappers run their plain versions anyway."""
    return decode_kernel == "kernel" and (
        q.device.type != "cuda" or q.shape[-1] in KERNEL_HEAD_DIMS)


@dataclass
class PagedStep:
    """What every layer of one forward shares: RoPE positions, the pool
    write targets, and the attention's tables and lengths (all on the
    model's device)."""
    positions: torch.Tensor     # [B, S] int64 absolute positions
    write_rows: torch.Tensor | None   # [N] int64 flat rows b*S+s that
                                # write; None: all B*S rows, in order
    write_slots: torch.Tensor   # [N] int64 flat pool targets page*BS+slot
    tables: torch.Tensor        # [B, NB] int32
    lengths: torch.Tensor       # [B] int32 live prefix before this step


@dataclass
class DenseStep:
    """What every layer of one dense-cache forward shares: the cache rows
    present before it, one host int for the whole batch or an int32 [B]
    tensor on the model's device. Request b's new rows sit at
    ``[length[b], length[b] + S)``, which are also their positions.
    A captured program passes the tensor (its value changes between
    replays); its caller then sizes the cache so that the rows stay
    inside it (``generate()``: P + bucket rows for at most P + n)."""
    length: int | torch.Tensor


def step_positions(step, B, S, device):
    """[B, S] absolute positions of a cache forward's new rows."""
    if isinstance(step, PagedStep):
        return step.positions
    if isinstance(step.length, torch.Tensor):
        return step.length.long()[:, None] + torch.arange(S, device=device)
    return torch.arange(step.length, step.length + S,
                        device=device).expand(B, S)


def attend_cached(q, k, v, k_pool, v_pool, step, paged, dense):
    """The cache branch's attention -> [B, S, H, D]. Under a ``PagedStep``
    the new K/V rows [B, S, Hkv, D] are scattered into the pools IN PLACE,
    then ``paged`` attends over the live prefix plus the causal new rows.
    Under a ``DenseStep`` they are written into the dense caches [B, Hkv,
    T, D] in place at ``[length, length + S)``, then ``dense`` attends.
    JAX's ``dynamic_update_slice`` clamps a start past the end;
    ``generate()`` never gets there, so a host length whose rows would
    pass T raises here (a device length is its caller's to bound).
    Under AMP q, k and v take the dtype of JAX's op of the branch
    (``paged_decode_attention`` / ``decode_attention``); the pools keep
    the dtype they were made with, written in place (JAX's branch returns
    caches cast to the op's dtype under O2: ROADMAP C)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if isinstance(step, PagedStep):
        q, k, v = _amp_cast("paged_decode_attention", q, k, v)
        paged_scatter_(k_pool, k, step.write_rows, step.write_slots)
        paged_scatter_(v_pool, v, step.write_rows, step.write_slots)
        return paged(q, k_pool, v_pool, step.tables, step.lengths,
                     scale=scale)
    q, k, v = _amp_cast("decode_attention", q, k, v)
    B, S, T = k.shape[0], k.shape[1], k_pool.shape[2]
    lo = step.length
    if isinstance(lo, torch.Tensor):
        pos = lo.long()[:, None] + torch.arange(S, device=k.device)
        b = torch.arange(B, device=k.device)[:, None]
        k_pool[b, :, pos] = k.to(k_pool.dtype)        # [B, S, Hkv, D]
        v_pool[b, :, pos] = v.to(v_pool.dtype)
    else:
        if lo + S > T:
            raise ValueError(f"dense cache holds {T} rows; {S} new rows "
                             f"at {lo} would pass its end")
        k_pool[:, :, lo:lo + S] = k.transpose(1, 2).to(k_pool.dtype)
        v_pool[:, :, lo:lo + S] = v.transpose(1, 2).to(v_pool.dtype)
    return dense(q, k_pool, v_pool, lo, scale=scale)
