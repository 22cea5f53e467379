"""Megatron sequence parallelism over the model-parallel group — the
counterpart of ``paddle_tpu/distributed/fleet/sequence_parallel_utils.py``
(Paddle ``fleet/utils/sequence_parallel_utils.py:85-137``, ``:429``,
``:564``).

Between tensor-parallel regions each rank holds a slice of the sequence
(``seq_dim``), so norms and dropout there cost 1/n; the all-reduce pair
of the TP layers becomes an all-gather before the column product and a
reduce-scatter after the row product. The JAX package writes these as
sharding constraints (GSPMD) or as ``lax`` collectives inside
``shard_map``; the port's ranks call the differentiable collectives of
``mp_ops``: ``scatter`` (cut; backward: gather), ``all_gather`` (backward:
reduce-scatter) and ``reduce_scatter`` (backward: gather). Without a
model-parallel group they are the identity.

``mark_as_sequence_parallel_parameter`` tags a replicated parameter used
on sequence slices (a norm's weight): its gradient is a partial sum per
rank, which the hybrid wrappers' gradient sync sums over the group at
the backward's end (``parallel.GradientSync``).
"""
from __future__ import annotations

from ...amp import _amp_cast
from ...tensor import Tensor
from .meta_parallel import ColumnParallelLinear, RowParallelLinear
from .mp_ops import gather_dim, mp_group, reduce_scatter_dim, scatter_dim

__all__ = [
    "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
    "scatter", "all_gather", "reduce_scatter",
    "mark_as_sequence_parallel_parameter",
    "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
]


def _apply(fn, x, seq_dim, group):
    g = mp_group(group)
    v = x._value if isinstance(x, Tensor) else x
    out = v if g is None else fn(v, seq_dim, g)
    return Tensor(out) if isinstance(x, Tensor) else out


def scatter(x, seq_dim=1, group=None):
    """The full sequence -> this rank's slice of it."""
    return _apply(scatter_dim, x, seq_dim, group)


def all_gather(x, seq_dim=1, group=None):
    """This rank's slice -> the full sequence on every rank."""
    return _apply(gather_dim, x, seq_dim, group)


def reduce_scatter(x, seq_dim=1, group=None):
    """Partial sums over the full sequence -> this rank's slice of their
    sum (the row-parallel epilogue)."""
    return _apply(reduce_scatter_dim, x, seq_dim, group)


class _OpFacade:
    """Paddle exposes these as PyLayer classes used through ``.apply()``."""

    def __init__(self, fn):
        self._fn = fn

    def apply(self, x, *a, **k):
        return self._fn(x, *a, **k)

    def __call__(self, x, *a, **k):
        return self._fn(x, *a, **k)


ScatterOp = _OpFacade(scatter)
GatherOp = _OpFacade(all_gather)
AllGatherOp = _OpFacade(all_gather)
ReduceScatterOp = _OpFacade(reduce_scatter)


def mark_as_sequence_parallel_parameter(param):
    param.sequence_parallel = True
    return param


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """Input sequence-sliced [B, S/n, in]: the sequence is all-gathered,
    then multiplied by the rank's columns; the output stays
    feature-sharded [B, S, out/n] (Paddle :429)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, mp_group=None,
                 name=None, device=None, dtype=None):
        if gather_output:
            raise ValueError("ColumnSequenceParallelLinear keeps its output "
                             "feature-sharded (gather_output=False)")
        super().__init__(in_features, out_features, has_bias=has_bias,
                         gather_output=False, mp_group=mp_group,
                         device=device, dtype=dtype)

    def forward(self, x):
        if self.group is None:
            return super().forward(x)
        full = gather_dim(x, 1, self.group)
        full, w, b = _amp_cast("linear", full, self.weight, self.bias)
        out = full @ w
        return out + b if b is not None else out


class RowSequenceParallelLinear(RowParallelLinear):
    """Input feature-sharded [B, S, in/n]: the rank's rows multiply it and
    the partial sums are reduce-scattered along the sequence, then the
    replicated bias is added: [B, S/n, out] (Paddle :564). The bias is
    marked sequence-parallel: each rank's gradient covers its slice."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, mp_group=None,
                 name=None, device=None, dtype=None):
        super().__init__(in_features, out_features, has_bias=has_bias,
                         input_is_parallel=True, mp_group=mp_group,
                         device=device, dtype=dtype)
        if self.bias is not None:
            # added to the rank's sequence slice: a partial gradient
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        if self.group is None:
            return super().forward(x)
        x, w, b = _amp_cast("linear", x, self.weight, self.bias)
        out = reduce_scatter_dim(x @ w, 1, self.group)
        return out + b if b is not None else out
