"""The tensor-parallel layers, ``ParallelCrossEntropy`` and the
``TensorParallel`` / ``SegmentParallel`` wrappers — the counterpart of
``paddle_tpu/distributed/fleet/meta_parallel.py:67-168`` and ``:413-442``;
the pipeline layers and wrappers (:172-411) live in ``pipeline.py`` and
are exported here too.

Weights keep paddle's ``[in, out]`` layout, so ``bridge.py`` copies the JAX
package's arrays without transposing them. The JAX package holds each
full weight with an "mp" sharding and lets GSPMD insert the collectives.
Here each rank of the model-parallel group (``mp_ops.mp_group``: the
``mp_group`` given, the hybrid group's, or the serving mesh's "tp" axis)
holds its shard and calls the collectives itself (Paddle ``mp_layers.py``):

* ``VocabParallelEmbedding``: rows ``[r V/n, (r+1) V/n)``; ids outside
  them look up zero rows, then the lookups are all-reduced;
* ``ColumnParallelLinear``: the rank's out-columns; its input's gradient
  is all-reduced; ``gather_output`` all-gathers the columns;
* ``RowParallelLinear``: the rank's in-rows; the partial products are
  all-reduced, then the (replicated) bias is added once;
* ``ParallelCrossEntropy``: over vocab-sharded logits, the local max,
  sum of exponentials and target logit each all-reduced; no rank holds
  the whole ``[tokens, V]`` (JAX :132-147).

Without a group (one rank, or none set) each layer is the single-device
form: ``x @ W (+ b)`` in plain ``torch.matmul``, as the JAX package left
the products to XLA outside any Pallas kernel. Under AMP
(``amp.auto_cast``, O1 and O2) each op casts its inputs under the name the
JAX package dispatches it by (``amp._amp_cast``): the lookup
``embedding``, the products ``linear``, and the cross entropy's
``subtract``, ``exp``, ``sum``, ``log`` (black-listed: f32), ``add`` and
``where``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...amp import _amp_add, _amp_cast
from ..collective import _all_reduce_
from ..layout import set_layout
from ..parallel import GradientSync
from .mp_ops import (
    allreduce_identity,
    gather_last,
    identity_allreduce,
    mp_group as _resolve_group,
    split_last,
)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "TensorParallel",
           "SegmentParallel", "shard_size", "mark_fused", "LayerDesc",
           "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "PipelineParallel", "PipelineParallelWithInterleave"]


def shard_size(total, group, what):
    """``total`` / nranks, raising when the group does not divide it."""
    n = 1 if group is None else group.nranks
    if total % n:
        raise ValueError(f"{what} {total} does not split over {n} "
                         f"model-parallel ranks")
    return total // n


def _mark(param, dim, group):
    """A sharded parameter carries ``is_distributed`` and its split
    dimension (the hybrid clip all-reduces its squared norm), and where it
    sits in the whole weight (``distributed.layout``: the checkpoint
    writes it there)."""
    param.is_distributed = group is not None
    param.split_axis = dim
    shape = list(param.shape)
    offset = [0] * len(shape)
    if group is not None and dim is not None:
        offset[dim] = group.rank * shape[dim]
        shape[dim] *= group.nranks
    set_layout(param, shape, [(tuple(slice(0, s) for s in param.shape),
                               offset)])


def mark_fused(param, parts, group):
    """``param``'s last dimension fuses ``parts`` (global widths), each cut
    over ``group`` and the rank's parts concatenated (GPT's ``qkv_proj``
    and ``gate_up``): one layout piece per part."""
    if group is None:
        return
    n, r = group.nranks, group.rank
    pieces, lo, glo = [], 0, 0
    lead = tuple(slice(0, s) for s in param.shape[:-1])
    for width in parts:
        w = width // n
        pieces.append((lead + (slice(lo, lo + w),),
                       [0] * (param.dim() - 1) + [glo + r * w]))
        lo, glo = lo + w, glo + width
    set_layout(param, list(param.shape[:-1]) + [glo], pieces)


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__()
        self.group = _resolve_group(mp_group)
        per = shard_size(num_embeddings, self.group, "vocab size")
        rank = self.group.rank if self.group is not None else 0
        self.vocab_start = rank * per
        self.vocab_end = self.vocab_start + per
        self.weight = nn.Parameter(torch.empty(
            per, embedding_dim, device=device, dtype=dtype))
        _mark(self.weight, 0, self.group)

    def reset_parameters(self, generator=None):
        nn.init.xavier_normal_(self.weight, generator=generator)

    def forward(self, ids):
        (w,) = _amp_cast("embedding", self.weight)
        if self.group is None:
            return w[ids]
        outside = (ids < self.vocab_start) | (ids >= self.vocab_end)
        local = torch.where(outside, torch.zeros_like(ids),
                            ids - self.vocab_start)
        rows = w[local] * (~outside).unsqueeze(-1).to(w.dtype)
        return allreduce_identity(rows, self.group)


class _Linear(nn.Module):
    def __init__(self, in_features, out_features, has_bias, group, split,
                 device, dtype):
        super().__init__()
        self.group = group
        if split == 1:
            out_features = shard_size(out_features, group, "out features")
        else:
            in_features = shard_size(in_features, group, "in features")
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        _mark(self.weight, split, group)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)
        if self.bias is not None:
            _mark(self.bias, 0 if split == 1 else None,
                  group if split == 1 else None)

    def reset_parameters(self, generator=None):
        nn.init.xavier_uniform_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class ColumnParallelLinear(_Linear):
    """y = x @ W (+ b), W [in, out / n] the rank's columns."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        group = _resolve_group(mp_group)
        super().__init__(in_features, out_features, has_bias, group, 1,
                         device, dtype)
        self.gather_output = gather_output

    def forward(self, x):
        if self.group is not None:
            x = identity_allreduce(x, self.group)
        x, w, b = _amp_cast("linear", x, self.weight, self.bias)
        out = x @ w
        out = out + b if b is not None else out
        if self.group is not None and self.gather_output:
            out = gather_last(out, self.group)
        return out


class RowParallelLinear(_Linear):
    """y = sum over ranks of x_r @ W_r (+ b), W [in / n, out] the rank's
    rows; the bias is replicated and added after the sum.
    ``_pre_reduce_hooks`` ({key: fn(layer, x_r, partial) -> partial}) act
    on the rank's partial product before the sum (a LoRA delta of the
    rank's rows of A)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        group = _resolve_group(mp_group)
        super().__init__(in_features, out_features, has_bias, group, 0,
                         device, dtype)
        self.input_is_parallel = input_is_parallel
        self._pre_reduce_hooks = {}

    def forward(self, x):
        if self.group is not None and not self.input_is_parallel:
            x = split_last(x, self.group)
        x, w, b = _amp_cast("linear", x, self.weight, self.bias)
        out = x @ w
        for hook in list(self._pre_reduce_hooks.values()):
            out = hook(self, x, out)
        if self.group is not None:
            out = allreduce_identity(out, self.group)
        return out + b if b is not None else out


class ParallelCrossEntropy(nn.Module):
    """Softmax cross entropy per token over the vocab axis, in the logits'
    dtype (bf16 under O2): lse = max + log(sum(exp(logits - max))) with the
    max detached, minus the target logit; 0 where the label is
    ``ignore_index`` (JAX :132-168). The JAX package sums a one-hot mask to
    pick the target; a gather of the same entry is the same value (a sum of
    one logit and zeros) without a [tokens, vocab] mask, and labels outside
    the vocab give 0 there too. Over a model-parallel group the logits are
    the rank's vocab columns; the max (no gradient), the sum of
    exponentials and the target logit are all-reduced, the last two with
    an identity backward, so each rank's gradient is its columns' softmax
    minus one-hot."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self.group = _resolve_group(mp_group)

    def forward(self, input, label):
        g = self.group
        vocab = input.shape[-1]
        start = 0 if g is None else g.rank * vocab
        squeeze = label.dim() == input.dim() and label.shape[-1] == 1
        lab = label.squeeze(-1) if squeeze else label
        (input,) = _amp_cast("max", input)
        m = input.amax(dim=-1, keepdim=True).detach()
        if g is not None:
            m = m.clone()
            _all_reduce_(m, "max", g)
        (e,) = _amp_cast("exp", torch.sub(*_amp_cast("subtract", input, m)))
        (e,) = _amp_cast("sum", torch.exp(e))
        e = e.sum(dim=-1)
        if g is not None:
            e = allreduce_identity(e, g)
        (e,) = _amp_cast("log", e)
        lse = _amp_add(torch.log(e), m.squeeze(-1))
        local = lab - start
        in_vocab = (local >= 0) & (local < vocab)
        (picked,) = _amp_cast("where", input)
        tgt = picked.gather(-1, local.clamp(0, vocab - 1).unsqueeze(-1))
        # JAX sums the masked row ("sum", f32 under O1 and O2): the one value
        (tgt,) = _amp_cast("sum", tgt.squeeze(-1))
        tgt = torch.where(in_vocab, tgt, torch.zeros_like(tgt))
        if g is not None:
            tgt = allreduce_identity(tgt, g)
        loss = torch.sub(*_amp_cast("subtract", lse, tgt))
        (loss,) = _amp_cast("where", loss)
        loss = torch.where(lab == self.ignore_index, torch.zeros_like(loss),
                           loss)
        return loss.unsqueeze(-1) if squeeze else loss


def _broadcast_replicated(model, group):
    """Every parameter and buffer not sharded over ``group`` takes rank 0's
    value (the group's first rank), so the replicas start equal."""
    from ..collective import broadcast

    if group is None or group.nranks <= 1:
        return
    with torch.no_grad():
        for p in list(model.parameters()) + list(model.buffers()):
            if not getattr(p, "is_distributed", False):
                broadcast(p.data, src=group.ranks[0], group=group)


def _hybrid_sync(model, hcg):
    """``GradientSync`` arguments of a hybrid wrapper: the gradients are
    averaged over the ranks that hold the same shards (the data x
    segment-parallel group; none when that group is this rank alone), and
    those of ``sequence_parallel`` parameters first summed over mp."""
    g = hcg.get_dp_sep_parallel_group()
    return dict(group=g if g.nranks > 1 else None,
                sp_group=hcg.get_model_parallel_group())


def _broadcast_all(model, group):
    from ..collective import broadcast

    if group is None or group.nranks <= 1:
        return
    with torch.no_grad():
        for p in list(model.parameters()) + list(model.buffers()):
            # an expert's copies are on the ranks holding its experts
            g = getattr(p, "_expert_group", None) or group
            broadcast(p.data, src=g.ranks[0], group=g)


class TensorParallel(GradientSync):
    """Paddle ``fleet/meta_parallel/tensor_parallel.py``: the layers already
    hold their shards; the wrapper makes the replicated parameters equal
    across the model-parallel group, and every parameter equal across the
    data x segment-parallel group, at wrap time, and its backward ends
    with the hybrid gradient sync (``parallel.GradientSync``)."""

    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, **_hybrid_sync(layers, hcg))
        self._hcg = hcg
        _broadcast_replicated(layers, hcg.get_model_parallel_group())
        _broadcast_all(layers, hcg.get_dp_sep_parallel_group())


class SegmentParallel(GradientSync):
    """Paddle ``fleet/meta_parallel/segment_parallel.py``: the model runs
    on the rank's sequence segment and attends through
    ``context_parallel`` over the sep group (``axis_name``). With a hybrid
    group the parameters start equal across the data x segment-parallel
    group and the backward ends with the hybrid gradient sync; without
    one the wrapper only passes its calls on."""

    def __init__(self, layers, hcg=None, strategy=None, axis_name="sep"):
        kw = (_hybrid_sync(layers, hcg) if hcg is not None
              else dict(group=None))
        super().__init__(layers, **kw)
        self._hcg = hcg
        self.axis_name = axis_name
        if hcg is not None:
            _broadcast_replicated(layers, hcg.get_model_parallel_group())
            _broadcast_all(layers, hcg.get_dp_sep_parallel_group())


from .pipeline import (  # noqa: E402,F401
    LayerDesc,
    PipelineLayer,
    PipelineParallel,
    PipelineParallelWithInterleave,
    SegmentLayers,
    SharedLayerDesc,
)
