"""paddle.incubate's top-level tail — the counterpart of
``paddle_tpu/incubate/_tail.py``. Reference: python/paddle/incubate/
__init__.py __all__: the graph ops (aliases over ``geometric``, under both
spellings), the fused softmax-mask ops, ``identity_loss``, and the
``LookAhead`` / ``ModelAverage`` optimizer wrappers.

The wrappers work in their eager ``step()`` as in JAX. ``jit.TrainStep``
refuses them (``_step_wrapper_name``): their work is outside the update
rule, and JAX's step raises for both (ROADMAP C). ``ModelAverage``'s
window arguments and ``graph_khop_sampler``'s ``sorted_eids`` are accepted
and never read by JAX; here another value than the default raises. The
samplers take a ``seed`` (an int or a ``numpy.random.Generator``) where
JAX draws from an unseeded generator.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ..geometric import reindex_graph as graph_reindex
from ..geometric import sample_neighbors as graph_sample_neighbors
from ..geometric import (
    reindex_graph,
    sample_neighbors,
    segment_max,
    segment_mean,
    segment_min,
    segment_sum,
    send_u_recv,
)
from ..ops import apply_like
from ..optimizer import Optimizer
from ..tensor import Tensor

__all__ = ["graph_send_recv", "graph_khop_sampler", "graph_reindex",
           "graph_sample_neighbors", "segment_sum", "segment_mean",
           "segment_max", "segment_min", "identity_loss",
           "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
           "LookAhead", "ModelAverage"]


def graph_send_recv(x, src_index, dst_index, pool_type="sum", out_size=None,
                    name=None):
    """The pre-geometric spelling of ``send_u_recv``."""
    return send_u_recv(x, src_index, dst_index, reduce_op=pool_type,
                       out_size=out_size)


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None,
                       seed=None):
    """Multi-hop neighbour sampling: ``sample_neighbors`` per hop from one
    generator, then one ``reindex_graph`` of the input nodes over the union
    (as JAX does, so the counts of a second hop do not line up with the
    input nodes and the reindex raises, in both packages). Returns
    (neighbors, counts, nodes, reindexed src)."""
    if sorted_eids is not None:
        raise NotImplementedError(
            "graph_khop_sampler(sorted_eids=...): the JAX package accepts "
            "the argument and never reads it")
    if return_eids:
        raise NotImplementedError("sorted_eids return is not supported")
    rng = np.random.default_rng(seed)
    cur, neighbors, counts = input_nodes, [], []
    for size in sample_sizes:
        neigh, cnt = sample_neighbors(row, colptr, cur, sample_size=size,
                                      seed=rng)
        neighbors.append(neigh._value)
        counts.append(cnt._value)
        cur = neigh
    neighbors = Tensor(torch.cat(neighbors))
    counts = Tensor(torch.cat(counts))
    src, _, nodes = reindex_graph(input_nodes, neighbors, counts)
    return neighbors, counts, nodes, src


def identity_loss(x, reduction="none"):
    """Marks x as a loss (for the reference's IPU scheduler); numerically
    a sum, a mean or x itself (``reduction`` 0 / 1 / 2 or the names)."""
    red = {0: "sum", 1: "mean", 2: "none"}.get(reduction, reduction)

    def f(v):
        if red == "sum":
            return v.sum()
        if red == "mean":
            return v.mean()
        return v

    return apply_like(f, "identity_loss", x)


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis, in f32, cast back."""
    return apply_like(lambda v, m: tF.softmax((v + m).float(), dim=-1)
                      .to(v.dtype), "softmax_mask_fuse", x, mask)


def softmax_mask_fuse_upper_triangle(x):
    """The causal-masked softmax (column <= row kept, others at -1e9)
    without a mask input."""
    def f(v):
        rows = torch.arange(v.shape[-2], device=v.device)[:, None]
        cols = torch.arange(v.shape[-1], device=v.device)[None, :]
        vv = torch.where(cols <= rows, v.float(),
                         torch.full((), -1e9, dtype=torch.float32,
                                    device=v.device))
        return tF.softmax(vv, dim=-1).to(v.dtype)

    return apply_like(f, "softmax_mask_fuse_upper_triangle", x)


class LookAhead(Optimizer):
    """Wraps an inner optimizer; every ``k`` steps the slow weights pull
    the fast ones back by ``alpha`` (reference incubate/optimizer/
    lookahead.py). The first sync only stores the slow weights, as in JAX
    (``_tail.py:115-121``)."""

    _step_wrapper_name = "LookAhead"

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._slow = {}
        self._lk_step = 0

    def __getattr__(self, name):
        return getattr(self.__dict__["inner_optimizer"], name)

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._lk_step += 1
        if self._lk_step % self.k:
            return
        for p in self.inner_optimizer._params:
            slow = self._slow.get(id(p))
            if slow is None:
                self._slow[id(p)] = p.detach().clone()
                continue
            slow = slow + self.alpha * (p - slow)
            self._slow[id(p)] = slow
            p.copy_(slow)

    def clear_grad(self, set_to_zero=False):
        self.inner_optimizer.clear_grad(set_to_zero)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage(Optimizer):
    """The running average of the parameters over the steps;
    ``apply()`` / ``restore()`` swap it in and out for evaluation
    (reference incubate/optimizer/modelaverage.py). JAX averages over every
    step and reads none of the three window arguments."""

    _step_wrapper_name = "ModelAverage"

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        for arg, value, default in (
                ("average_window_rate", average_window_rate, 0.15),
                ("min_average_window", min_average_window, 10000),
                ("max_average_window", max_average_window, 10000)):
            if value != default:
                raise NotImplementedError(
                    f"ModelAverage({arg}={value!r}): the JAX package "
                    f"averages over every step and never reads it")
        super().__init__(0.0, parameters, None, None, name)
        self._sum = {}
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        self._count += 1
        for p in self._params:
            acc = self._sum.get(id(p))
            self._sum[id(p)] = (p.detach().clone() if acc is None
                                else acc + p)

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        self._backup = {}
        for p in self._params:
            if id(p) in self._sum and self._count:
                self._backup[id(p)] = p.detach().clone()
                p.copy_((self._sum[id(p)] / self._count).to(p.dtype))

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._params:
            if id(p) in self._backup:
                p.copy_(self._backup[id(p)])
        self._backup = None
