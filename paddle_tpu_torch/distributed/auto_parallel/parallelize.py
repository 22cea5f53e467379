"""The ``parallelize`` plan API — the counterpart of
``paddle_tpu/distributed/auto_parallel/parallelize.py`` (Paddle
``intermediate/parallelize.py:51``, ``intermediate/tensor_parallel.py``,
``intermediate/pipeline_parallel.py:30``).

The JAX package annotates a matched layer's parameters ``Shard(dim)`` over
the mesh's "mp" axis and constrains activations; GSPMD then inserts the
collectives. A rank of the port holds its part, so each plan cuts the
matched layer's parameters over this rank's "mp" group (in place, as
``shard_tensor`` cuts a parameter: ``_dist_attr``, ``is_distributed``,
``split_axis`` and the checkpoint layout are set) and puts the collectives
in the layer's forward with the autograd ops of ``fleet.mp_ops``:

* ``ColWiseParallel``: a Linear's weight [in, out] cut on its output dim,
  the bias with it (an Embedding's weight on its feature dim). The input
  goes through identity forward / all-reduce backward; with
  ``gather_output`` the output's last dim is gathered.
* ``RowWiseParallel``: the weight cut on its input dim (an Embedding's on
  its vocabulary: ids outside this rank's rows look up zeros). With
  ``is_input_parallel=False`` the input's last dim is cut first. The
  output is all-reduced, and the bias added after the reduction.
* The sequence-parallel plans cut and gather dim 1 of activations over
  "mp", as ``fleet.sequence_parallel_utils`` does: ``Begin`` cuts the
  layer's output (backward: gather), ``End`` gathers its input (backward:
  cut), ``Enable`` keeps input and output cut, ``Disable`` runs the layer
  on the whole sequence and cuts its output. A cut activation carries the
  mark ``_seq_sharded``; a column-parallel layer that receives one gathers
  it (backward: reduce-scatter) in place of its identity / all-reduce.
  The mark does not cross a pipeline stage's boundary.

A layer whose parameters are already cut (a ``fleet`` tensor-parallel
layer built under the group) is left as it is. With no "mp" axis, or one
of size 1, the plans cut nothing and change no forward. JAX's edge
behaviour is kept: a dim that does not divide stays whole with JAX's
warning; a plan key that matches no layer warns; a key may name one
parameter (``path.weight`` / ``path.bias``, with ``.`` or ``\\.``);
unknown config keys raise; without a mesh the config is ignored with its
warning. ``pipeline_parallel`` records ``_pp_chain`` / ``_pp_bounds`` /
``_pp_mesh`` as JAX does; ``DistModel`` runs them through
``fleet.pipeline``. ``sharded_data_parallel`` lays a ZeRO stage over "dp"
(``shard_optimizer``).
"""
from __future__ import annotations

import re
import warnings
from enum import Enum

import numpy as np
import torch

from ...tensor import Tensor
from ..api import _local_part, shard_dataloader
from ..layout import layout_of, set_layout
from ..mesh import (
    ProcessMesh, Replicate, Shard, axis_group, get_mesh, set_mesh,
)
from ..sharding import (
    ShardingStage1, ShardingStage2, ShardingStage3, shard_optimizer,
)

__all__ = [
    "ColWiseParallel", "RowWiseParallel", "PlanBase", "PrepareLayerInput",
    "PrepareLayerOutput", "SequenceParallelBegin", "SequenceParallelDisable",
    "SequenceParallelEnable", "SequenceParallelEnd", "SplitPoint",
    "parallelize", "tensor_parallel", "pipeline_parallel",
    "sharded_data_parallel", "ToDistributedConfig", "to_distributed",
]


class SplitPoint(Enum):
    """Reference: intermediate/pipeline_parallel.py:30."""

    BEGINNING = 0
    END = 1


# ------------------------------------------------------------- helpers
def _raw(x):
    return x._value if isinstance(x, Tensor) else x


def _like(x, v):
    return Tensor(v) if isinstance(x, Tensor) else v


def _mp_group(mesh):
    """This rank's group along the mesh's "mp" axis, or None (no axis, one
    rank, or a rank outside the mesh)."""
    return None if mesh is None else axis_group("mp", mesh)


def _param(layer, name):
    return layer._parameters.get(name) if name in layer._parameters else None


def _is_cut(p):
    # a torch tensor's own ``is_distributed`` is a method: only the flag
    # a cut sets counts
    return getattr(p, "is_distributed", False) is True


def _shard_param(p, mesh, dim):
    """Cut the torch parameter ``p`` in place to this rank's part of dim
    ``dim`` over "mp"; False where nothing is cut (JAX ``:42-57``)."""
    if p is None or "mp" not in mesh.dim_names or not mesh.contains():
        return False
    idx = mesh.dim_names.index("mp")
    n = mesh.shape[idx]
    if n <= 1 or dim >= p.dim() or _is_cut(p):
        return False
    if p.shape[dim] % n != 0:
        warnings.warn(
            f"parallelize: cannot shard dim {dim} of shape {list(p.shape)} "
            f"over mp={n}; leaving replicated")
        return False
    placements = [Replicate()] * mesh.ndim
    placements[idx] = Shard(dim)
    local = _local_part(p.detach(), mesh, placements)
    with torch.no_grad():
        p.data = local
    set_layout(p, *layout_of(local))
    p._dist_attr = (mesh, placements)
    p.is_distributed = True
    p.split_axis = dim
    return True


def _get(layer, name):
    """The layer's parameter as its forward reads it (a ZeRO-3 module's
    property gathers it), as a torch tensor."""
    v = getattr(layer, name, None)
    return _raw(v) if v is not None else None


def _seq_sharded(v):
    return bool(getattr(v, "_seq_sharded", False))


def _mark(v, on):
    v._seq_sharded = on
    return v


def _seq_cut(x, g):
    """Dim 1 of ``x`` cut over ``g`` (backward: gathered), marked."""
    from ..fleet.mp_ops import scatter_dim

    v = _raw(x)
    if g is None or not isinstance(v, torch.Tensor) or v.dim() < 2 \
            or _seq_sharded(v):
        return x
    return _like(x, _mark(scatter_dim(v, 1, g), True))


def _seq_whole(x, g):
    """A marked ``x`` gathered on dim 1 (backward: cut)."""
    from ..fleet.mp_ops import _GatherDim

    v = _raw(x)
    if g is None or not isinstance(v, torch.Tensor) or not _seq_sharded(v):
        return x
    return _like(x, _mark(_GatherDim.apply(v, 1, g, False), False))


def _map_out(out, fn):
    if isinstance(out, (tuple, list)):
        return type(out)(fn(o) for o in out)
    return fn(out)


# ---------------------------------------------------------------- plans
class PlanBase:
    """``apply(layer, process_mesh, shard_param_list)`` changes the matched
    layer in place (reference tensor_parallel.py:95)."""

    def apply(self, layer, process_mesh, shard_param_list=None):
        raise NotImplementedError


def _is_embedding(layer):
    from ...nn.layer_common import Embedding

    return isinstance(layer, (Embedding, torch.nn.Embedding))


class ColWiseParallel(PlanBase):
    """A Linear's output dim / an Embedding's feature dim over "mp"
    (reference tensor_parallel.py:103)."""

    def __init__(self, gather_output=False):
        self.gather_output = gather_output

    def apply(self, layer, process_mesh, shard_param_list=None):
        names = shard_param_list or ("weight", "bias")
        cut = False
        for name in names:
            p = _param(layer, name)
            if p is not None:
                cut |= _shard_param(p, process_mesh,
                                    1 if p.dim() >= 2 else 0)
        if not cut:
            return
        g = _mp_group(process_mesh)
        if _is_embedding(layer):
            if self.gather_output:
                from ..fleet.mp_ops import gather_last

                layer.register_forward_hook(
                    lambda l, i, out: _map_out(
                        out, lambda o: _like(o, gather_last(_raw(o), g))))
            return
        layer.forward = _col_forward(layer, g, self.gather_output)


def _col_forward(layer, g, gather_output):
    from ...nn import functional as F
    from ..fleet.mp_ops import gather_dim, gather_last, identity_allreduce

    def forward(x):
        v = _raw(x)
        v = (gather_dim(v, 1, g) if _seq_sharded(v)
             else identity_allreduce(v, g))
        w, b = _get(layer, "weight"), _get(layer, "bias")
        if b is not None and not _is_cut(_param(layer, "bias")):
            b = b.chunk(g.nranks)[g.rank]    # a key that cut the weight only
        y = F.linear(v, w, b)
        if gather_output:
            y = gather_last(y, g)
        return _like(x, y)

    return forward


class RowWiseParallel(PlanBase):
    """A Linear's input dim / an Embedding's vocabulary over "mp"; the bias
    stays whole and is added after the all-reduce (reference
    tensor_parallel.py:211)."""

    def __init__(self, is_input_parallel=True):
        self.is_input_parallel = is_input_parallel

    def apply(self, layer, process_mesh, shard_param_list=None):
        names = shard_param_list or ("weight",)
        cut = False
        for name in names:
            p = _param(layer, name)
            if p is not None:
                cut |= _shard_param(p, process_mesh, 0)
        if not cut:
            return
        g = _mp_group(process_mesh)
        layer.forward = (_vocab_forward(layer, g) if _is_embedding(layer)
                         else _row_forward(layer, g, self.is_input_parallel))


def _row_forward(layer, g, is_input_parallel):
    from ...nn import functional as F
    from ..fleet.mp_ops import allreduce_identity, split_last

    def forward(x):
        v = _raw(x)
        if not is_input_parallel:
            v = split_last(v, g)
        y = allreduce_identity(F.linear(v, _get(layer, "weight")), g)
        b = _get(layer, "bias")
        if b is not None:
            y = y + b.to(y.dtype)
        return _like(x, y)

    return forward


def _vocab_forward(layer, g):
    from ..fleet.mp_ops import allreduce_identity

    w = _param(layer, "weight")
    rows = w.shape[0]
    lo = g.rank * rows

    def forward(ids):
        v = _raw(ids)
        local = v - lo
        miss = (local < 0) | (local >= rows)
        out = torch.nn.functional.embedding(local.masked_fill(miss, 0),
                                            _get(layer, "weight"))
        out = out.masked_fill(miss.unsqueeze(-1), 0)
        return _like(ids, allreduce_identity(out, g))

    return forward


class PrepareLayerInput(PlanBase):
    """``fn(process_mesh)`` returns a forward pre-hook ``hook(layer,
    inputs)`` (reference tensor_parallel.py:308)."""

    def __init__(self, fn=None):
        self.fn = fn

    def apply(self, layer, process_mesh, shard_param_list=None):
        layer.register_forward_pre_hook(self.fn(process_mesh))


class PrepareLayerOutput(PlanBase):
    """``fn(process_mesh)`` returns a forward post-hook ``hook(layer,
    inputs, outputs)`` (reference tensor_parallel.py:363)."""

    def __init__(self, fn=None):
        self.fn = fn

    def apply(self, layer, process_mesh, shard_param_list=None):
        layer.register_forward_hook(self.fn(process_mesh))


class SequenceParallelBegin(PlanBase):
    """After this layer activations are cut on the sequence over "mp"
    (reference tensor_parallel.py:418)."""

    def __init__(self, need_transpose=True):
        self.need_transpose = need_transpose

    def apply(self, layer, process_mesh, shard_param_list=None):
        g = _mp_group(process_mesh)
        if g is not None:
            layer.register_forward_hook(
                lambda l, inp, out: _map_out(out, lambda o: _seq_cut(o, g)))


class SequenceParallelEnd(PlanBase):
    """Before this layer activations are whole again (reference
    tensor_parallel.py:470)."""

    def __init__(self, need_transpose=True):
        self.need_transpose = need_transpose

    def apply(self, layer, process_mesh, shard_param_list=None):
        g = _mp_group(process_mesh)
        if g is not None:
            layer.register_forward_pre_hook(
                lambda l, inputs: tuple(_seq_whole(x, g) for x in inputs))


class SequenceParallelEnable(PlanBase):
    """This layer runs on sequence slices: input and output stay cut
    (reference tensor_parallel.py:522)."""

    def apply(self, layer, process_mesh, shard_param_list=None):
        g = _mp_group(process_mesh)
        if g is None:
            return
        layer.register_forward_pre_hook(
            lambda l, inputs: tuple(_seq_cut(x, g) for x in inputs))
        layer.register_forward_hook(
            lambda l, inp, out: _map_out(out, lambda o: _seq_cut(o, g)))


class SequenceParallelDisable(PlanBase):
    """This layer runs on the whole sequence inside a sequence-parallel
    region (reference tensor_parallel.py:579)."""

    def __init__(self, need_transpose=True):
        self.need_transpose = need_transpose

    def apply(self, layer, process_mesh, shard_param_list=None):
        g = _mp_group(process_mesh)
        if g is None:
            return
        layer.register_forward_pre_hook(
            lambda l, inputs: tuple(_seq_whole(x, g) for x in inputs))
        layer.register_forward_hook(
            lambda l, inp, out: _map_out(out, lambda o: _seq_cut(o, g)))


# ------------------------------------------------------------- matching
def _match_layers(model, pattern):
    """(name, sublayer) for one plan key: exact, then ``re.fullmatch``
    over the named sublayers."""
    out = []
    for name, sub in model.named_modules():
        if sub is model:
            continue
        if name == pattern or re.fullmatch(pattern, name):
            out.append((name, sub))
    return out


def tensor_parallel(model, parallelize_plan, mesh):
    """Apply an "mp" ``parallelize_plan`` in place."""
    if parallelize_plan is None:
        return model
    for key, plan in parallelize_plan.items():
        plans = plan if isinstance(plan, (list, tuple)) else [plan]
        shard_param_list = None
        layer_key = key
        # "path.weight" / "path.bias" names one parameter; the separator
        # may be a plain '.' or an escaped '\.' in regex keys
        m = re.search(r"(?:\\\.|\.)(weight|bias)$", key)
        if m:
            layer_key = key[:m.start()]
            shard_param_list = [m.group(1)]
        matches = _match_layers(model, layer_key)
        if not matches:
            warnings.warn(f"parallelize: plan key {key!r} matched no layer")
        for _, sub in matches:
            for p in plans:
                p.apply(sub, mesh, shard_param_list)
    return model


# ---------------------------------------------------------- pp split
def _flatten_chain(model):
    """Ordered (qualified name, layer) chain of the model's children,
    containers (LayerList / Sequential) flattened."""
    from ...nn.layer_common import LayerList, Sequential

    containers = (LayerList, Sequential, torch.nn.ModuleList,
                  torch.nn.Sequential)
    chain = []

    def walk(prefix, layer):
        for name, child in layer.named_children():
            qual = f"{prefix}.{name}" if prefix else name
            if isinstance(child, containers):
                walk(qual, child)
            else:
                chain.append((qual, child))

    walk("", model)
    return chain


def pipeline_parallel(model, optimizer, split_spec, global_spec=None,
                      mesh=None):
    """Record ``model``'s stage decomposition over the mesh's "pp" axis
    (JAX ``:262-311``): ``_pp_chain``, ``_pp_bounds``, ``_pp_mesh``."""
    mesh = mesh or get_mesh()
    pp = mesh.get_dim_size("pp") if "pp" in mesh.dim_names else 1
    if pp <= 1:
        return model
    chain = _flatten_chain(model)
    names = [n for n, _ in chain]

    if isinstance(split_spec, str):
        # prefix form: the matching layer run split evenly into pp stages
        region = [i for i, n in enumerate(names)
                  if n == split_spec or n.startswith(split_spec + ".")]
        if not region:
            raise ValueError(f"split_spec {split_spec!r} matched no layers")
        lo, hi = region[0], region[-1] + 1
        span = hi - lo
        bounds = [0]
        for s in range(1, pp):
            bounds.append(lo + (span * s) // pp)
        bounds.append(len(chain))
    else:
        cut_points = []
        for key, point in split_spec.items():
            idx = [i for i, n in enumerate(names)
                   if n == key or re.fullmatch(key, n)]
            if not idx:
                raise ValueError(f"split_spec key {key!r} matched no layer")
            for i in idx:
                cut_points.append(i if point == SplitPoint.BEGINNING else i + 1)
        bounds = [0] + sorted(set(cut_points)) + [len(chain)]
        bounds = sorted(set(bounds))
        if len(bounds) - 1 != pp:
            raise ValueError(
                f"split_spec produces {len(bounds) - 1} stages but the mesh "
                f"pp axis is {pp}")
    if global_spec:
        warnings.warn(
            "parallelize: global_spec layers are kept replicated across "
            "stages (each stage holds its own copy)")
    model._pp_chain = chain
    model._pp_bounds = bounds
    model._pp_mesh = mesh
    return model


# ---------------------------------------------------------- top level
def sharded_data_parallel(model, optimizer, level, mesh=None):
    """``sharding_level`` 1-3: the ZeRO stage over "dp" (reference
    intermediate/sharded_data_parallel.py)."""
    if optimizer is None or not level:
        return model, optimizer
    stages = {1: ShardingStage1, 2: ShardingStage2, 3: ShardingStage3}
    stage = stages[int(level)]("dp", mesh)
    return model, shard_optimizer(optimizer, stage)


def parallelize(model, optimizer=None, mesh=None, config=None):
    """``config``: ``dp_config`` {sharding_level}, ``mp_config``
    {parallelize_plan}, ``pp_config`` {split_spec, global_spec}. Returns
    (model, optimizer)."""
    mesh = mesh or get_mesh()
    config = dict(config or {})
    known = {"dp_config", "mp_config", "pp_config"}
    unknown = set(config) - known
    if unknown:
        raise ValueError(f"unknown parallelize config keys: {sorted(unknown)}")
    if mesh is None:
        if config:
            warnings.warn(
                "parallelize: no mesh set (dist.auto_parallel.set_mesh) and "
                "none passed — the config is IGNORED and the model stays "
                "fully replicated (reference-documented no-op)")
        return model, optimizer
    if not (known & set(config)):
        return model, optimizer
    if "mp_config" in config:
        tensor_parallel(model, config["mp_config"].get("parallelize_plan"),
                        mesh)
    if "pp_config" in config:
        pp_cfg = config["pp_config"]
        model = pipeline_parallel(model, optimizer, pp_cfg.get("split_spec"),
                                  pp_cfg.get("global_spec"), mesh)
    if "dp_config" in config:
        model, optimizer = sharded_data_parallel(
            model, optimizer, config["dp_config"].get("sharding_level", 0),
            mesh)
    return model, optimizer


class ToDistributedConfig:
    """The input spec and the sequence-parallel hint of
    ``to_distributed`` (reference auto_parallel/high_level_api.py)."""

    def __init__(self):
        self.input_spec = None
        self.sequence_parallel = False


def to_distributed(model, optimizer, dataloader, device_num, node_num=1,
                   config=None):
    """JAX ``:366-393``: a ("dp", "sep") mesh when ``sequence_parallel``
    is asked and ``device_num`` is even, else a 1-d "dp" mesh, installed
    globally; ZeRO-2 over "dp" on the optimizer; the loader cut over
    "dp"."""
    seq_par = bool(config is not None
                   and getattr(config, "sequence_parallel", False))
    if seq_par and device_num % 2 == 0:
        mesh = ProcessMesh(
            np.arange(device_num).reshape(device_num // 2, 2), ["dp", "sep"])
    else:
        mesh = ProcessMesh(np.arange(device_num), ["dp"])
    set_mesh(mesh)
    if optimizer is not None:
        optimizer = shard_optimizer(optimizer, ShardingStage2("dp", mesh))
    loader = shard_dataloader(dataloader, meshes=[mesh], shard_dims="dp")
    return model, optimizer, loader
