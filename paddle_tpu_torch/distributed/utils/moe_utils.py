"""The MoE exchanges ``global_scatter`` / ``global_gather`` — the
counterpart of ``paddle_tpu/distributed/utils/moe_utils.py`` (Paddle
``moe_utils.py:20``, ``:153``).

The layout is JAX's: a capacity-padded, rank-major buffer
``[world * n_local_expert * capacity, d]`` whose block j is bound for
rank j of the group. The exchange sends block j to rank j and puts what
rank i sent in block i, so it is an involution on that layout and
``global_gather`` is the same exchange. In the port it is one
``torch.distributed.all_to_all_single`` on the group (NCCL on the card,
gloo on the CPU), inside an ``autograd.Function`` whose backward is the
same exchange. It runs whenever a group is given, at one rank too (the
card then launches the all-to-all); without a group the op is the
identity, as JAX's outside a trace.

``local_count`` / ``global_count`` (Paddle's per-(rank, expert) token
counts), when given, are checked against the padded layout: one count
per (rank, local expert) block, none above the block's capacity. JAX's
docstring promises that check and its code reads neither (ROADMAP C).
The check reads the counts on the host, so a captured step passes none.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ...tensor import Tensor
from ..collective import _pg

__all__ = ["global_scatter", "global_gather", "exchange", "launches"]

# all-to-all exchanges issued (the card's launch count)
launches = 0


def _exchange(v, g):
    global launches
    world = g.nranks
    if v.shape[0] % world:
        raise ValueError(f"{v.shape[0]} rows do not split into {world} "
                         "rank-major blocks")
    v = v.contiguous()
    out = torch.empty_like(v)
    with torch.no_grad():
        dist.all_to_all_single(out, v, group=_pg(g))
    launches += 1
    return out


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, g, loss_share):
        ctx.g, ctx.share = g, loss_share
        return _exchange(v, g)

    @staticmethod
    def backward(ctx, grad):
        if ctx.share is None:
            return _exchange(grad, ctx.g), None, None
        # what leaves carries this rank's loss weight; what arrives is put
        # in units of this rank's loss, which the gradient sync weights
        return _exchange(grad * ctx.share, ctx.g) / ctx.share, None, None


def exchange(v, group, loss_share=None):
    """The exchange of the torch tensor ``v`` over ``group``, its backward
    the same exchange. ``loss_share`` (this rank's share of the
    data-parallel batch, set by ``parallel.GradientSync``): the gradient
    sent scaled by the sender's share and divided by the receiver's, so a
    rank's loss keeps its weight when the ranks' batches differ."""
    return _Exchange.apply(v, group, loss_share)


def _check_counts(rows, world, local_count, global_count):
    for name, c in (("local_count", local_count),
                    ("global_count", global_count)):
        if c is None:
            continue
        c = torch.as_tensor(getattr(c, "_value", c)).reshape(-1)
        if c.numel() % world or rows % c.numel():
            raise ValueError(
                f"{name} of {c.numel()} entries does not describe "
                f"{world} ranks' expert blocks of {rows} rows")
        cap = rows // c.numel()
        if int(c.max()) > cap or int(c.min()) < 0:
            raise ValueError(f"{name} {c.tolist()} outside the padded "
                             f"capacity {cap} of each (rank, expert) block")


def global_scatter(x, local_count=None, global_count=None, group=None,
                   use_calc_stream=True):
    """Send the capacity-padded expert blocks of ``x`` ``[world *
    n_local_expert * capacity, d]`` (rank-major) to their ranks; rank i's
    blocks for this rank come back in block i. Without ``group``, ``x``
    as it is. A ``Tensor`` in gives a ``Tensor`` out."""
    v = x._value if isinstance(x, Tensor) else x
    if group is None:
        return x
    _check_counts(v.shape[0], group.nranks, local_count, global_count)
    out = exchange(v, group)
    return Tensor(out) if isinstance(x, Tensor) else out


def global_gather(x, local_count=None, global_count=None, group=None,
                  use_calc_stream=True):
    """The inverse of ``global_scatter``: the experts' outputs back to the
    ranks that own the tokens (the same exchange: an involution)."""
    return global_scatter(x, local_count, global_count, group,
                          use_calc_stream)
