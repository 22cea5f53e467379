"""MoE gates — the counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate``. Reference:
python/paddle/incubate/distributed/models/moe/gate/ (naive_gate.py,
gshard_gate.py:31, switch_gate.py:31).

A gate scores tokens with one linear map and routes them top-k with a
per-expert capacity: the index form (``topk_capacity_routing_indices``:
expert, slot, kept and gate value per round and token) and the dense
GShard form derived from it (``topk_capacity_routing``: combine weights
and dispatch mask [T, E, C]), so both dispatch modes take the same
decisions. Every shape is static and nothing reads a value on the host,
so the routing runs inside a CUDA graph capture.
"""
from __future__ import annotations

import math

import torch

from ......nn import initializer as I
from ......nn.layer import Layer

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate",
           "topk_capacity_routing", "topk_capacity_routing_indices",
           "load_balance_loss"]


def topk_capacity_routing(probs, k: int, capacity: int, normalize_topk=True):
    """Dense top-k routing with per-expert capacity. probs: [T, E]
    softmax probabilities. Returns (combine [T, E, C] in probs' dtype,
    dispatch [T, E, C] bool, the top-1 one-hot [T, E]); tokens past an
    expert's capacity are dropped (no contribution). A scatter of the index
    form's decisions (JAX: out-of-range rows dropped; here scattered into a
    spare expert row that is cut off)."""
    T, E = probs.shape
    eids, locs, keeps, gvals, top1 = topk_capacity_routing_indices(
        probs, k, capacity, normalize_topk)
    t_idx = torch.arange(T, device=probs.device).expand_as(eids)
    e_safe = torch.where(keeps, eids, E)
    l_safe = torch.where(keeps, locs, 0)
    combine = torch.zeros((T, E + 1, capacity), dtype=probs.dtype,
                          device=probs.device)
    combine = combine.index_put(
        (t_idx.reshape(-1), e_safe.reshape(-1).long(),
         l_safe.reshape(-1).long()),
        (gvals * keeps).reshape(-1).to(probs.dtype), accumulate=True)
    combine = combine[:, :E]
    return combine, combine > 0, top1


def topk_capacity_routing_indices(probs, k: int, capacity: int,
                                  normalize_topk=True):
    """The same routing decisions as flat indices: (eids, locs, keeps,
    gvals) each [k, T], and the top-1 one-hot [T, E] for the balance loss.
    Round r takes each token's r-th best expert; its slot is the count of
    earlier tokens of the round and of all tokens of earlier rounds that
    went there, and it is kept while that is below ``capacity``."""
    T, E = probs.shape
    masked = probs
    prev_counts = torch.zeros(E, dtype=probs.dtype, device=probs.device)
    eids, locs, keeps, gvals = [], [], [], []
    top1 = None
    for r in range(k):
        idx = torch.argmax(masked, dim=1)
        onehot = torch.nn.functional.one_hot(idx, E).to(probs.dtype)
        if r == 0:
            top1 = onehot
        gval = (probs * onehot).sum(dim=1)
        loc_round = torch.cumsum(onehot, dim=0) - onehot
        loc = (loc_round * onehot).sum(dim=1) + onehot @ prev_counts
        eids.append(idx.to(torch.int32))
        locs.append(loc.to(torch.int32))
        keeps.append(loc < capacity)
        gvals.append(gval)
        prev_counts = prev_counts + onehot.sum(dim=0)
        masked = masked * (1.0 - onehot)
    gvals = torch.stack(gvals)
    if normalize_topk and k > 1:
        gvals = gvals / (gvals.sum(dim=0, keepdim=True) + 1e-9)
    return (torch.stack(eids), torch.stack(locs), torch.stack(keeps), gvals,
            top1)


def load_balance_loss(probs, top1_onehot, group=None, loss_share=None):
    """GShard's aux loss: E * sum_e mean_prob_e * mean_top1_frac_e (also
    Switch's N * sum(f_i * P_i)). Over a ``group`` of more than one rank
    the means are over every rank's tokens: the per-expert sums and the
    token count go into one all-reduce of a [2, E + 1] tensor, whose
    gradient is summed back over the group (each rank's loss reads it),
    each rank's weighted by ``loss_share`` when given
    (``mp_ops.allreduce_sum``)."""
    E = probs.shape[1]
    if group is None or group.nranks <= 1:
        return E * (probs.mean(dim=0) * top1_onehot.mean(dim=0)).sum()
    from ......distributed.fleet.mp_ops import allreduce_sum

    count = probs.new_full((2, 1), probs.shape[0])
    stats = allreduce_sum(torch.cat([
        torch.stack([probs.sum(dim=0), top1_onehot.sum(dim=0)]), count],
        dim=1), group, loss_share)
    me = stats[0, :E] / stats[0, E]
    ce = stats[1, :E] / stats[1, E]
    return E * (me * ce).sum()


class BaseGate(Layer):
    # this rank's share of the data-parallel batch (parallel.GradientSync)
    _loss_share = None

    def __init__(self, num_expert, world_size=1):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None
        # the group whose tokens the balance statistics cover (set by an
        # expert-parallel MoELayer)
        self._stats_group = None

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss

    def set_loss(self, loss):
        self.loss = loss


class NaiveGate(BaseGate):
    """Linear scoring and top-k with no drop (capacity = T)."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2):
        super().__init__(num_expert, world_size)
        self.d_model = d_model
        self.top_k = topk
        self.weight = self.create_parameter(
            [d_model, self.tot_expert], default_initializer=I.XavierUniform())

    def capacity_for(self, num_tokens):
        return int(num_tokens)

    def route(self, logits, capacity):
        """(combine, dispatch, aux loss): the dense form."""
        probs = torch.softmax(logits.float(), dim=-1)
        combine, dispatch, top1 = topk_capacity_routing(probs, self.top_k,
                                                        capacity)
        return combine, dispatch, load_balance_loss(
            probs, top1, self._stats_group, self._loss_share)

    def route_indices(self, logits, capacity):
        """(eids, locs, keeps, gvals) [k, T] and the aux loss: the
        gather / scatter form."""
        probs = torch.softmax(logits.float(), dim=-1)
        eids, locs, keeps, gvals, top1 = topk_capacity_routing_indices(
            probs, self.top_k, capacity)
        return eids, locs, keeps, gvals, load_balance_loss(
            probs, top1, self._stats_group, self._loss_share)


class GShardGate(NaiveGate):
    """Top-2 with capacity and the balance loss (gshard_gate.py:31); the
    capacity factor is ``capacity[0]`` (1.2), as in JAX."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None):
        super().__init__(d_model, num_expert, world_size, topk=topk)
        self.capacity_factor = (capacity[0]
                                if isinstance(capacity, (tuple, list))
                                else float(capacity))

    def capacity_for(self, num_tokens):
        return max(1, int(math.ceil(
            self.capacity_factor * self.top_k * num_tokens
            / self.tot_expert)))


class SwitchGate(NaiveGate):
    """Top-1 with capacity and the balance loss (switch_gate.py:31)."""

    def __init__(self, d_model, num_expert, world_size=1, topk=1,
                 capacity=(1.2, 2.4), switch_eps=0.1, group=None):
        super().__init__(d_model, num_expert, world_size, topk=1)
        self.capacity_factor = (capacity[0]
                                if isinstance(capacity, (tuple, list))
                                else float(capacity))
        self.switch_eps = switch_eps

    def capacity_for(self, num_tokens):
        return max(1, int(math.ceil(
            self.capacity_factor * num_tokens / self.tot_expert)))
