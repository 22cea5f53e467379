"""paddle.geometric — graph message passing, segment ops, neighbour
sampling and reindexing: the counterpart of ``paddle_tpu/geometric``.

Reference: python/paddle/geometric/ (message_passing/send_recv.py:55
send_u_recv, :210 send_ue_recv, :413 send_uv; math.py segment ops;
sampling/neighbors.py; reindex.py).

Message passing gathers rows (``index_select``) and reduces them onto the
destinations with ``scatter_reduce`` over a known destination count, through
``ops.apply_op`` under JAX's op names, so autograd and AMP reach them as any
op. Segments a reduction leaves empty are 0, as in JAX (which maps the
+-inf identities of max / min to 0, and so also a max of +inf; the port does
the same). The segment ops read the segment count from the ids (one host
read), as JAX needs it concrete. Sampling and reindexing are host work on
numpy, as in JAX, and their results go back to the input's device (the
samplers' ``row``, reindexing's ``x``), as JAX's land on its default
device; the draws come from ``np.random.default_rng(seed)`` (a ``seed=``
keyword the port adds) where JAX draws from an unseeded ``RandomState``,
so neither package repeats the other's samples.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import apply_op
from ..tensor import Tensor

__all__ = ["send_u_recv", "send_ue_recv", "send_uv", "segment_sum",
           "segment_mean", "segment_max", "segment_min", "sample_neighbors",
           "weighted_sample_neighbors", "reindex_graph",
           "reindex_heter_graph"]


def _num_segments(count, fallback):
    if count is None:
        return fallback
    if isinstance(count, Tensor):
        return int(count._value)
    return int(count)


def _apply_ue(xv, ev, op):
    if op == "add":
        return xv + ev
    if op == "sub":
        return xv - ev
    if op == "mul":
        return xv * ev
    if op == "div":
        return xv / ev
    raise ValueError(f"message op {op!r} not supported")


def _reduce(msgs, dst, n, pool):
    """Rows of ``msgs`` reduced onto ``n`` destinations by ``dst``."""
    if pool not in ("sum", "mean", "max", "min"):
        raise ValueError(f"reduce op {pool!r} not supported")
    shape = (n,) + tuple(msgs.shape[1:])
    index = dst.reshape((-1,) + (1,) * (msgs.ndim - 1)).expand_as(msgs)
    out = torch.zeros(shape, dtype=msgs.dtype, device=msgs.device)
    if pool == "sum":
        return out.scatter_add(0, index, msgs)
    if pool == "mean":
        s = out.scatter_add(0, index, msgs)
        cnt = torch.zeros(n, dtype=msgs.dtype, device=msgs.device).index_add(
            0, dst, torch.ones(msgs.shape[0], dtype=msgs.dtype,
                               device=msgs.device))
        return s / cnt.clamp(min=1.0).reshape((-1,) + (1,) * (msgs.ndim - 1))
    out = out.scatter_reduce(0, index, msgs, "amax" if pool == "max"
                             else "amin", include_self=False)
    if msgs.is_floating_point():
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    else:
        info = torch.iinfo(out.dtype)
        sentinel = info.min if pool == "max" else info.max
        out = torch.where(out == sentinel, torch.zeros_like(out), out)
    return out


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather x[src], reduce onto dst (reference send_recv.py:55)."""
    n_default = int(x.shape[0])

    def f(xv, src, dst):
        n = _num_segments(out_size, n_default)
        msgs = xv.index_select(0, src.long())
        return _reduce(msgs, dst.long(), n, reduce_op.lower())

    return apply_op(f, "send_u_recv", x, src_index, dst_index)


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Gather x[src], combine with edge features y, reduce onto dst
    (reference send_recv.py:210)."""
    n_default = int(x.shape[0])

    def f(xv, ev, src, dst):
        n = _num_segments(out_size, n_default)
        msgs = _apply_ue(xv.index_select(0, src.long()), ev,
                         message_op.lower())
        return _reduce(msgs, dst.long(), n, reduce_op.lower())

    return apply_op(f, "send_ue_recv", x, y, src_index, dst_index)


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """Per-edge message from both endpoints (reference send_recv.py:413)."""

    def f(xv, yv, src, dst):
        return _apply_ue(xv.index_select(0, src.long()),
                         yv.index_select(0, dst.long()), message_op.lower())

    return apply_op(f, "send_uv", x, y, src_index, dst_index)


def _segment(name, pool):
    def fn(data, segment_ids, name=None):
        def f(d, seg):
            n = int(seg.max()) + 1          # one host read, as JAX's int()
            return _reduce(d, seg.long(), n, pool)

        return apply_op(f, fn.__name__, data, segment_ids)

    fn.__name__ = fn.__qualname__ = name
    return fn


segment_sum = _segment("segment_sum", "sum")
segment_mean = _segment("segment_mean", "mean")
segment_max = _segment("segment_max", "max")
segment_min = _segment("segment_min", "min")


def _host(v):
    """A Tensor, torch tensor or array as a numpy array."""
    v = v._value if isinstance(v, Tensor) else v
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _device(v):
    """The device of a Tensor or torch tensor; the CPU for an array."""
    v = v._value if isinstance(v, Tensor) else v
    return v.device if isinstance(v, torch.Tensor) else torch.device("cpu")


def _to(device, *arrays):
    """numpy arrays as Tensors on ``device``."""
    return tuple(Tensor(torch.from_numpy(a).to(device)) for a in arrays)


def _sample_neighbors_impl(row, colptr, input_nodes, sample_size, eids,
                           return_eids, edge_weight=None, seed=None):
    """(Weighted) neighbour sampling of a CSC graph on the host, uniform
    without weights, weight-proportional with them, without replacement;
    draws from ``np.random.default_rng(seed)``."""
    rowv, cpv, nodes = _host(row), _host(colptr), _host(input_nodes)
    wv = (_host(edge_weight).astype(np.float64)
          if edge_weight is not None else None)
    ev = _host(eids) if eids is not None else None
    rng = np.random.default_rng(seed)
    out_n, out_e, counts = [], [], []
    for n in nodes.tolist():
        lo, hi = int(cpv[n]), int(cpv[n + 1])
        neigh = rowv[lo:hi]
        idx = np.arange(lo, hi)
        if 0 <= sample_size < len(neigh):
            p = None
            if wv is not None:
                p = wv[lo:hi] / wv[lo:hi].sum()
            pick = rng.choice(len(neigh), size=sample_size, replace=False,
                              p=p)
            neigh, idx = neigh[pick], idx[pick]
        out_n.append(neigh)
        counts.append(len(neigh))
        if ev is not None:
            out_e.append(ev[idx])
    outs = [np.concatenate(out_n) if out_n else np.zeros((0,), rowv.dtype),
            np.asarray(counts, np.int64)]
    if return_eids:
        if ev is None:
            raise ValueError("return_eids=True requires eids")
        outs.append(np.concatenate(out_e))
    return _to(_device(row), *outs)


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None,
                     seed=None):
    """Uniform neighbour sampling from a CSC graph (row: the concatenated
    neighbour lists, colptr: their offsets); ``seed`` seeds the draw."""
    return _sample_neighbors_impl(row, colptr, input_nodes, sample_size, eids,
                                  return_eids, seed=seed)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None, return_eids=False,
                              name=None, seed=None):
    """Neighbour sampling with probability proportional to edge weight."""
    return _sample_neighbors_impl(row, colptr, input_nodes, sample_size, eids,
                                  return_eids, edge_weight=edge_weight,
                                  seed=seed)


def _renumber(mapping, out_nodes, values):
    for n in values.tolist():
        if n not in mapping:
            mapping[n] = len(mapping)
            out_nodes.append(n)


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """Renumber (x ∪ neighbors) into a contiguous id space; returns
    (reindexed_src, reindexed_dst, out_nodes) (reference reindex.py)."""
    xv, nv, cv = _host(x), _host(neighbors), _host(count)
    mapping, out_nodes = {}, []
    _renumber(mapping, out_nodes, xv)
    _renumber(mapping, out_nodes, nv)
    src = np.asarray([mapping[n] for n in nv.tolist()], np.int64)
    dst = np.repeat(np.arange(len(xv), dtype=np.int64), cv)
    return _to(_device(x), src, dst, np.asarray(out_nodes, xv.dtype))


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """The heterogeneous form: per-edge-type neighbour / count lists
    sharing one node id space."""
    xv = _host(x)
    mapping, out_nodes = {}, []
    _renumber(mapping, out_nodes, xv)
    srcs, dsts = [], []
    for nb, ct in zip(neighbors, count):
        nv, cv = _host(nb), _host(ct)
        _renumber(mapping, out_nodes, nv)
        srcs.append(np.asarray([mapping[n] for n in nv.tolist()], np.int64))
        dsts.append(np.repeat(np.arange(len(xv), dtype=np.int64), cv))
    return _to(_device(x), np.concatenate(srcs), np.concatenate(dsts),
               np.asarray(out_nodes, xv.dtype))
