"""The dist-tensor API — the counterpart of
``paddle_tpu/distributed/api.py`` (Paddle ``auto_parallel/api.py:220``
``shard_tensor``, ``:797`` ``reshard``, ``:908`` ``shard_layer``), ZeRO
aside.

The JAX package places one global array over the mesh's devices. A rank
of the port holds its own part: ``shard_tensor(data, mesh, placements)``
takes the global value (every rank has it) and returns a ``DistTensor``
whose value is this rank's part — along each mesh dimension with
``Shard(d)``, the rank's chunk of tensor dimension d, by its coordinate on
that mesh dimension. ``reshard`` moves between placements with the
collectives of each mesh dimension's group: Shard -> Replicate
all-gathers, Replicate -> Shard takes the chunk, Partial -> Replicate
all-reduces by the partial's reduce type, Shard(a) -> Shard(b) gathers
then cuts. ``dtensor_from_local`` wraps a rank's part as it is;
``unshard_dtensor`` gathers the global value. ``shard_dataloader`` gives
each rank its slice of every batch along the data-parallel mesh
dimension.

``ShardingStage1/2/3``, ``shard_optimizer`` and ``shard_scaler`` (ZeRO)
live in ``sharding.py`` and are exported here too.
"""
from __future__ import annotations

import torch

from ..tensor import Tensor
from .collective import _all_reduce_, _gather_cat
from .layout import cut_pieces, layout_of, set_layout
from .mesh import Partial, Placement, ProcessMesh, Replicate, Shard, get_mesh
from .sharding import (  # noqa: F401
    ShardingStage1,
    ShardingStage2,
    ShardingStage3,
    shard_optimizer,
    shard_scaler,
)

__all__ = ["DistTensor", "shard_tensor", "dtensor_from_local",
           "dtensor_from_fn", "reshard", "unshard_dtensor", "shard_layer",
           "shard_dataloader", "shard_optimizer", "shard_scaler",
           "ShardingStage1", "ShardingStage2", "ShardingStage3",
           "ReduceType", "DistAttr", "Placement"]

class DistTensor(Tensor):
    """A Tensor holding this rank's part of a global value laid out by
    ``_dist_attr`` = (mesh, placements)."""

    def __init__(self, value, dist_attr, global_shape, stop_gradient=True):
        super().__init__(value, stop_gradient=stop_gradient)
        self._dist_attr = dist_attr
        self._global_shape = list(global_shape)

    @property
    def process_mesh(self):
        return self._dist_attr[0]

    @property
    def placements(self):
        return list(self._dist_attr[1])

    @property
    def global_shape(self):
        return list(self._global_shape)


def _val(x):
    if isinstance(x, Tensor):
        return x._value
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _pieces_for(shape, mesh, placements):
    """Where this rank's part of a ``shape`` tensor under ``placements``
    sits (``layout``)."""
    coord = mesh.get_coord()
    shape = [int(s) for s in shape]
    pieces = [(tuple(slice(0, s) for s in shape), [0] * len(shape))]
    local = list(shape)
    for axis, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n, d = mesh.shape[axis], pl.get_dim()
            pieces = cut_pieces(local, pieces, d, n, coord[axis])
            local[d] //= n
    return pieces


def _local_part(v, mesh, placements):
    """This rank's part of ``v``, with its layout (where it sits in ``v``,
    ``layout``: the sharded checkpoint reads it)."""
    coord = mesh.get_coord()
    shape = list(v.shape)
    for axis, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.shape[axis]
            d = pl.get_dim()
            if v.shape[d] % n:
                raise ValueError(f"dim {d} of size {v.shape[d]} does not "
                                 f"split over mesh dim {axis} of size {n}")
            v = v.chunk(n, dim=d)[coord[axis]]
    return set_layout(v.contiguous(), shape,
                      _pieces_for(shape, mesh, placements))


def _wrap(data, v, mesh, placements, global_shape, stop_gradient):
    if stop_gradient is None:
        stop_gradient = getattr(data, "stop_gradient", True)
    return DistTensor(v, (mesh, list(placements)), global_shape,
                      stop_gradient=stop_gradient)


def shard_tensor(data, mesh: ProcessMesh, placements, dtype=None,
                 place=None, stop_gradient=None):
    """This rank's part of the global ``data`` under ``placements``. A
    parameter (a Layer's ``nn.Parameter``) is cut in place: its storage
    becomes the part, and it keeps its identity."""
    v = _val(data)
    if dtype is not None:
        v = v.to(dtype)
    local = _local_part(v, mesh, placements)
    if hasattr(data, "trainable"):        # a Layer's nn.Parameter
        with torch.no_grad():
            data._value.data = local
        set_layout(data._value, *layout_of(local))
        # kept on its torch parameter (the wrapper has fixed slots)
        data._value._dist_attr = (mesh, list(placements))
        data._value._global_shape = list(v.shape)
        return data
    return _wrap(data, local, mesh, placements, v.shape, stop_gradient)


def dtensor_from_local(local_tensor, mesh, placements):
    """``local_tensor`` as this rank's part (no data moves); the global
    shape multiplies each sharded dimension by its mesh dimension."""
    v = _val(local_tensor)
    shape = list(v.shape)
    for axis, pl in enumerate(placements):
        if isinstance(pl, Shard):
            shape[pl.get_dim()] *= mesh.shape[axis]
    set_layout(v, shape, _pieces_for(shape, mesh, placements))
    return _wrap(local_tensor, v, mesh, placements, shape, None)


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def _dist_attr(t):
    """(mesh, placements, global shape) of a dist tensor or a parameter cut
    by ``shard_tensor``; None for a whole value."""
    for holder in (t, getattr(t, "_value", None)):
        attr = getattr(holder, "_dist_attr", None)
        if attr is not None:
            return (*attr, holder._global_shape)
    return None


def reshard(dist_tensor, mesh: ProcessMesh, placements):
    """The value under new ``placements`` (same mesh): per mesh dimension,
    Partial is reduced, Shard gathered where the target differs, then cut
    to the target's Shards."""
    t = dist_tensor
    src_mesh, src, global_shape = _dist_attr(t)
    if src_mesh != mesh:
        raise NotImplementedError("reshard across meshes is not ported")
    v = t._value
    for axis, (a, b) in enumerate(zip(src, placements)):
        if a == b:
            continue
        g = mesh.get_group(axis)
        if isinstance(a, Partial):
            v = v.clone()
            _all_reduce_(v, a.reduce_type, g)
        elif isinstance(a, Shard):
            v = _gather_cat(v, a.get_dim(), g)
        if isinstance(b, Shard):
            n, d = mesh.shape[axis], b.get_dim()
            v = v.chunk(n, dim=d)[mesh.get_coord()[axis]].contiguous()
        elif isinstance(b, Partial):
            raise NotImplementedError("resharding to Partial is not ported")
    set_layout(v, global_shape, _pieces_for(global_shape, mesh, placements))
    return DistTensor(v, (mesh, list(placements)), global_shape,
                      stop_gradient=t.stop_gradient)


def unshard_dtensor(dist_tensor):
    """The global value, replicated on every rank."""
    attr = _dist_attr(dist_tensor)
    if attr is None:
        return dist_tensor
    mesh = attr[0]
    return reshard(dist_tensor, mesh, [Replicate()] * mesh.ndim)


def shard_layer(layer, process_mesh, shard_fn=None, input_fn=None,
                output_fn=None):
    """``shard_fn(name, sublayer, mesh)`` on every sublayer (it calls
    ``shard_tensor`` on parameters); by default every parameter stays
    whole (replicated)."""

    def default_fn(name, sublayer, mesh):
        pass

    fn = shard_fn or default_fn
    for name, sub in layer.named_sublayers(include_self=True):
        fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda mod, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_post_hook(
            lambda mod, inp, out: output_fn(out, process_mesh))
    return layer


class _ShardedDataLoader:
    """Each batch's leading dimension cut by this rank's coordinate on
    ``shard_dims`` (each rank reads its slice)."""

    def __init__(self, loader, mesh, shard_dims):
        self._loader = loader
        self._mesh = mesh
        self._dim = (shard_dims if isinstance(shard_dims, str) else
                     (shard_dims[0] if shard_dims else mesh.dim_names[0]))

    def __len__(self):
        return len(self._loader)

    def _place(self, x):
        v = x._value if isinstance(x, Tensor) else x
        n = self._mesh.get_dim_size(self._dim)
        if not isinstance(v, torch.Tensor) or v.dim() == 0 or n <= 1:
            return x
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} does not split over "
                             f"{self._dim}={n}")
        me = self._mesh.get_coord()[self._mesh.dim_names.index(self._dim)]
        part = v.chunk(n, dim=0)[me]
        return Tensor(part, stop_gradient=x.stop_gradient) if isinstance(
            x, Tensor) else part

    def __iter__(self):
        for batch in self._loader:
            if isinstance(batch, (list, tuple)):
                yield type(batch)(self._place(b) for b in batch)
            else:
                yield self._place(batch)


def shard_dataloader(dataloader, meshes=None, shard_dims=None,
                     is_dataset_splitted=False):
    mesh = meshes[0] if isinstance(meshes, (list, tuple)) and meshes else (
        meshes or get_mesh())
    if mesh is None or is_dataset_splitted:
        return dataloader
    return _ShardedDataLoader(dataloader, mesh, shard_dims)


class ReduceType:
    """Paddle ``reduce_type.h``: the reduction a Partial placement holds."""
    kRedSum = 0
    kRedMax = 1
    kRedMin = 2
    kRedProd = 3
    kRedAvg = 4
    kRedAny = 5
    kRedAll = 6


class DistAttr:
    """Paddle ``auto_parallel/api.py:159``: (mesh, per-tensor-dim mesh axis
    name) — the legacy spelling of placements."""

    def __init__(self, mesh, sharding_specs):
        self.process_mesh = mesh
        self.sharding_specs = list(sharding_specs)

    def placements(self):
        out = []
        for axis in self.process_mesh.dim_names:
            tensor_dim = next((d for d, spec in enumerate(self.sharding_specs)
                               if spec == axis), None)
            out.append(Replicate() if tensor_dim is None
                       else Shard(tensor_dim))
        return out
