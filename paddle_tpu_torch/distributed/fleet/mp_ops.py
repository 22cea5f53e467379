"""The differentiable collectives of tensor and sequence parallelism
(Paddle ``fleet/layers/mpu/mp_ops.py``, Megatron's f / g pairs).

Where the JAX package keeps global shapes and lets GSPMD transpose its
collectives, each rank of the port holds its shard and calls these
``torch.autograd.Function``s:

* ``identity_allreduce`` (Paddle ``_c_identity``): identity forward,
  all-reduce of the gradient (the input of a column-parallel product);
* ``allreduce_sum``: all-reduce forward and backward (a sum every rank's
  loss reads, such as MoE's balance statistics);
* ``allreduce_identity`` (``_mp_allreduce``): all-reduce forward, identity
  backward (the output of a row-parallel product, the embedding lookup);
* ``gather_last`` / ``split_last`` (``_c_concat`` / ``_c_split``): the
  last dimension gathered or cut, the gradient the other way;
* ``gather_dim`` / ``reduce_scatter_dim`` / ``scatter_dim``: sequence
  parallelism's all-gather (backward: reduce-scatter), reduce-scatter
  (backward: all-gather) and cut (backward: all-gather) along a dimension.

``mp_group(group)`` resolves the model-parallel group a layer works over:
the one given, else the hybrid group's mp axis (``fleet.init``), else the
global mesh's "mp" or "tp" axis (``serving_mesh``); None — the
single-device forms — when there is none or it holds one rank.
"""
from __future__ import annotations

import torch

from ..collective import (
    _all_reduce_,
    _gather_cat,
    _reduce_scatter_dim,
)

__all__ = ["mp_group", "identity_allreduce", "allreduce_identity",
           "allreduce_sum", "gather_last", "split_last", "gather_dim",
           "reduce_scatter_dim", "scatter_dim"]


def mp_group(group=None):
    """The model-parallel group of a layer, or None (single device).
    ``group=False`` asks for the single-device form whatever is set."""
    if group is False:
        return None
    if group is None:
        from .base import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        if hcg is not None and hcg.get_model_parallel_world_size() > 1:
            group = hcg.get_model_parallel_group()
        else:
            from ..mesh import axis_group

            group = axis_group(("mp", "tp"))
    if group is None or group.nranks <= 1:
        return None
    return group


def _chunk(v, dim, g):
    n = g.nranks
    if v.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {v.shape[dim]} does not split "
                         f"over {n} ranks")
    return v.chunk(n, dim=dim)[g.rank].contiguous()


def _reduced(v, g):
    out = v.contiguous().clone()
    _all_reduce_(out, "sum", g)
    return out


class _IdentityAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad, ctx.g), None


class _AllReduceIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _reduced(x, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, loss_share):
        ctx.g, ctx.share = g, loss_share
        return _reduced(x, g)

    @staticmethod
    def backward(ctx, grad):
        if ctx.share is None:
            return _reduced(grad, ctx.g), None, None
        return _reduced(grad * ctx.share, ctx.g) / ctx.share, None, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g, grad_reduce):
        ctx.dim, ctx.g, ctx.reduce = dim, g, grad_reduce
        return _gather_cat(x, dim, g)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce:
            return _reduce_scatter_dim(grad.contiguous(), ctx.dim,
                                       ctx.g), None, None, None
        return _chunk(grad, ctx.dim, ctx.g), None, None, None


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _reduce_scatter_dim(x.contiguous(), dim, g)

    @staticmethod
    def backward(ctx, grad):
        return _gather_cat(grad, ctx.dim, ctx.g), None, None


class _ScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _chunk(x, dim, g)

    @staticmethod
    def backward(ctx, grad):
        return _gather_cat(grad, ctx.dim, ctx.g), None, None


def identity_allreduce(x, g):
    return _IdentityAllReduce.apply(x, g)


def allreduce_identity(x, g):
    return _AllReduceIdentity.apply(x, g)


def allreduce_sum(x, g, loss_share=None):
    """The sum over the group, whose gradient is the sum of every rank's
    gradients: each rank's loss reads the same total. ``loss_share`` (this
    rank's share of the data-parallel batch): each rank's gradient
    weighted by its share, in units of the receiver's, as
    ``moe_utils.exchange`` does."""
    return _AllReduceSum.apply(x, g, loss_share)


def gather_last(x, g):
    """All-gather of the last dimension; the gradient is cut back."""
    return _GatherDim.apply(x, x.dim() - 1, g, False)


def split_last(x, g):
    """This rank's part of the last dimension; the gradient is gathered."""
    return _ScatterDim.apply(x, x.dim() - 1, g)


def gather_dim(x, dim, g):
    """All-gather along ``dim``; the gradient is reduce-scattered (every
    rank's output feeds a different shard of the next product)."""
    return _GatherDim.apply(x, dim, g, True)


def reduce_scatter_dim(x, dim, g):
    return _ReduceScatterDim.apply(x, dim, g)


def scatter_dim(x, dim, g):
    return _ScatterDim.apply(x, dim, g)
