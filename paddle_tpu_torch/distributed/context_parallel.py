"""Context parallelism: ring attention and Ulysses over a sequence-parallel
group — the counterpart of ``paddle_tpu/distributed/context_parallel.py``.

Every function takes the rank's sequence shard in paddle's
flash-attention layout [B, S/n, H, D], rank i holding global positions
[i S/n, (i+1) S/n), and returns the rank's output shard. The group is the
one given, else the hybrid group's "sep" axis, else the global mesh's
axis ``axis_name``.

* ``ring_attention`` (JAX :60-117): the plain online-softmax loop in f32;
  K / V rotate one hop a step (rank i receives from i + 1, so step t
  holds origin (i + t) mod n) through the differentiable ``shift``, whose
  backward rotates the gradients back. It calls no kernel, as in JAX.
* ``ulysses_attention`` (JAX :120-147): an all-to-all swaps the sequence
  shard for a head shard ([B, S/n, H, D] -> [B, S, H/n, D]), the port's
  flash attention runs on the whole sequence of the local heads (the
  flash kernels on the card at head dims 64 and 128), and a second
  all-to-all restores the layout. Both all-to-alls carry gradients.
"""
from __future__ import annotations

import math

import torch

from .collective import _like, _val, all_to_all_dim, shift
from .fleet.meta_parallel import SegmentParallel  # noqa: F401
from .mesh import axis_group

__all__ = ["ring_attention", "ulysses_attention", "split_sequence",
           "RingFlashAttention", "SegmentParallel", "sep_group"]


def sep_group(axis_name="sep", group=None):
    """The group a context-parallel call runs over."""
    if group is not None:
        return group
    from .fleet.base import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if (axis_name == "sep" and hcg is not None
            and hcg.get_sep_parallel_world_size() > 1):
        return hcg.get_sep_parallel_group()
    g = axis_group(axis_name)
    if g is None:
        raise ValueError(f"no group along {axis_name!r}: pass group= or "
                         f"install a mesh with that axis")
    return g


def _bhsd(x):
    return x.transpose(1, 2)        # [B,S,H,D] <-> [B,H,S,D]


def _broadcast_kv(qh, kh, vh):
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    return kh, vh


def ring_attention(q, k, v, axis_name="sep", causal=False, scale=None,
                   group=None):
    g = sep_group(axis_name, group)
    n, me = g.nranks, g.rank
    kind = q
    q, k, v = _val(q), _val(k), _val(v)
    b, s_loc, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    qh = _bhsd(q).float()
    kh, vh = _broadcast_kv(qh, _bhsd(k).float(), _bhsd(v).float())
    neg = torch.finfo(torch.float32).min
    o = torch.zeros_like(qh)
    m = torch.full((b, qh.shape[1], s_loc, 1), neg, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, qh.shape[1], s_loc, 1), dtype=torch.float32,
                    device=q.device)
    rows = me * s_loc + torch.arange(s_loc, device=q.device)
    k_cur, v_cur = kh, vh
    for step in range(n):
        origin = (me + step) % n
        sc = torch.einsum("bhsd,bhtd->bhst", qh, k_cur) * scale
        if causal:
            cols = origin * s_loc + torch.arange(s_loc, device=q.device)
            allowed = rows[:, None] >= cols[None, :]
            sc = torch.where(allowed, sc, torch.full_like(sc, neg))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.einsum("bhst,bhtd->bhsd", p, v_cur)
        m = m_new
        if step + 1 < n:
            k_cur = shift(k_cur, -1, g)
            v_cur = shift(v_cur, -1, g)
    out = o / l.clamp(min=1e-38)
    return _like(kind, _bhsd(out).to(q.dtype))


def _local_attention(q, k, v, causal, scale):
    """Attention over [B, S, H, D]: the port's flash attention where its
    kernels serve the shape (their plain versions on the CPU), the plain
    softmax otherwise."""
    from ..nn.functional.flash_attention import _takes_kernel
    from ..ops import flash_attention as fa

    if _takes_kernel(q, k, "ulysses_attention"):
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    qh = _bhsd(q).float()
    kh, vh = _broadcast_kv(qh, _bhsd(k).float(), _bhsd(v).float())
    sc = torch.einsum("bhsd,bhtd->bhst", qh, kh) * scale
    if causal:
        s, t = sc.shape[-2], sc.shape[-1]
        mask = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril(t - s)
        sc = torch.where(mask, sc,
                         torch.full_like(sc, torch.finfo(torch.float32).min))
    out = torch.einsum("bhst,bhtd->bhsd", sc.softmax(dim=-1), vh)
    return _bhsd(out).to(q.dtype)


def ulysses_attention(q, k, v, axis_name="sep", causal=False, scale=None,
                      attention_fn=None, group=None):
    g = sep_group(axis_name, group)
    n = g.nranks
    kind = q
    q, k, v = _val(q), _val(k), _val(v)
    h, d = q.shape[2], q.shape[3]
    if h % n or k.shape[2] % n:
        raise ValueError(f"Ulysses needs heads ({h}, kv {k.shape[2]}) "
                         f"divisible by the group size ({n})")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    # [B, S/n, H, D] -> [B, S, H/n, D]
    qf, kf, vf = (all_to_all_dim(x, 2, 1, g) for x in (q, k, v))
    out = (attention_fn or _local_attention)(qf, kf, vf, causal=causal,
                                             scale=scale)
    return _like(kind, all_to_all_dim(out, 1, 2, g))   # [B, S/n, H, D]


def split_sequence(x, axis_name="sep", seq_dim=1, group=None):
    """This rank's sequence shard of a replicated value."""
    g = sep_group(axis_name, group)
    v = _val(x)
    if v.shape[seq_dim] % g.nranks:
        raise ValueError(f"sequence length {v.shape[seq_dim]} not divisible "
                         f"by sep={g.nranks}")
    return _like(x, v.chunk(g.nranks, dim=seq_dim)[g.rank])


class RingFlashAttention:
    """A callable over (q, k, v) in paddle's layout: ring attention over
    ``axis_name`` (or ``group``)."""

    def __init__(self, axis_name="sep", causal=True, scale=None, group=None):
        self.axis_name = axis_name
        self.causal = causal
        self.scale = scale
        self.group = group

    def __call__(self, q, k, v):
        return ring_attention(q, k, v, axis_name=self.axis_name,
                              causal=self.causal, scale=self.scale,
                              group=self.group)
