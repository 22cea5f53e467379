"""``ProcessMesh`` and the placements — the counterpart of
``paddle_tpu/distributed/mesh.py``.

The JAX package wraps a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives. In the port a mesh is an n-dimensional array of global ranks;
each dimension maps to the process groups of the ranks that differ only
along it (``get_group(dim)``: this rank's group along ``dim``). A mesh
built after ``init_parallel_env`` creates all of its groups at once, every
rank the same groups in the same order, as ``torch.distributed`` demands;
a mesh built before it is only a layout, and asking it for a group raises.

``serving_mesh(dp, tp)`` (JAX :384-392) builds and installs the
("dp", "tp") mesh of the serving step programs: the GPT layers, the paged
pool and the step programs take their tensor-parallel group from its
"tp" axis (``mesh_axis_size``, ``axis_group``). ``SpecLayout`` keeps JAX's
declared partition entries of that mesh as plain tuples.
"""
from __future__ import annotations

import itertools

import numpy as np

from . import env

__all__ = ["Placement", "Shard", "Replicate", "Partial", "ProcessMesh",
           "set_mesh", "get_mesh", "auto_mesh", "serving_mesh",
           "mesh_axis_size", "axis_group", "SpecLayout"]


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim):
        self.dim = dim

    def is_shard(self, dim=None):
        return True if dim is None else dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))


class Replicate(Placement):
    def is_replicate(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("replicate")


class Partial(Placement):
    """A pending reduction: each rank holds a part; ``reshard`` to
    ``Replicate`` reduces them by ``reduce_type``."""

    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, other):
        return (isinstance(other, Partial)
                and other.reduce_type == self.reduce_type)

    def __hash__(self):
        return hash(("partial", self.reduce_type))


class ProcessMesh:
    """``mesh``: nested lists (or an array) of global ranks;
    ``dim_names``: one name per dimension."""

    def __init__(self, mesh, dim_names=None, process_ids=None):
        arr = np.asarray(mesh)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(f"{len(dim_names)} names for a {arr.ndim}-d "
                             f"mesh")
        self._shape = list(arr.shape)
        self._dim_names = list(dim_names)
        self._process_ids = [int(r) for r in arr.reshape(-1)]
        self._groups = None
        if env.is_initialized():
            world = env.get_world_size()
            if arr.size != world or sorted(self._process_ids) != list(
                    range(world)):
                raise ValueError(
                    f"a mesh of {arr.size} ranks {self._process_ids} over a "
                    f"world of {world}: the mesh must hold every rank once")
            self._groups = self._make_groups()

    def _make_groups(self):
        """{dim name: this rank's Group along it}: every group of every
        dimension is created, in one order, on every rank."""
        from .collective import new_group

        ids = self.mesh
        me = env.get_rank()
        mine = {}
        for axis, name in enumerate(self._dim_names):
            others = [range(s) for i, s in enumerate(self._shape)
                      if i != axis]
            for coord in itertools.product(*others):
                index = list(coord)
                index.insert(axis, slice(None))
                ranks = [int(r) for r in ids[tuple(index)]]
                g = new_group(ranks, axis_name=name)
                if me in ranks:
                    mine[name] = g
        return mine

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return list(self._process_ids)

    @property
    def mesh(self):
        return np.asarray(self._process_ids).reshape(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    def get_dim_size(self, name):
        return self._shape[self._dim_names.index(name)]

    def _dim(self, dim):
        return self._dim_names.index(dim) if isinstance(dim, str) else dim

    def get_rank_by_dim_and_process_id(self, dim, pid):
        idx = self._process_ids.index(pid)
        coords = np.unravel_index(idx, self._shape)
        return int(coords[self._dim(dim)])

    def get_coord(self, rank=None):
        """This rank's (or ``rank``'s) coordinate on every dimension."""
        rank = env.get_rank() if rank is None else rank
        idx = self._process_ids.index(rank)
        return [int(c) for c in np.unravel_index(idx, self._shape)]

    def get_group(self, dim):
        """This rank's group along ``dim`` (a name or an index)."""
        if self._groups is None:
            raise RuntimeError(
                "this mesh was built before init_parallel_env(): it has no "
                "process groups")
        name = dim if isinstance(dim, str) else self._dim_names[dim]
        return self._groups[name]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and other._shape == self._shape
                and other._dim_names == self._dim_names
                and other._process_ids == self._process_ids)

    def __hash__(self):
        return hash((tuple(self._shape), tuple(self._dim_names),
                     tuple(self._process_ids)))

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dim_names={self._dim_names})"


_GLOBAL: dict = {"mesh": None}


def set_mesh(mesh):
    _GLOBAL["mesh"] = mesh
    return mesh


def get_mesh():
    return _GLOBAL["mesh"]


def auto_mesh(*axis_sizes, dim_names=None) -> ProcessMesh:
    """A mesh over ranks 0..n-1 with the given axis sizes (row-major)."""
    n = int(np.prod(axis_sizes))
    return ProcessMesh(np.arange(n).reshape(axis_sizes), dim_names)


def serving_mesh(dp=1, tp=1, *, set_global=True) -> ProcessMesh:
    """The ("dp", "tp") serving mesh over ranks 0..dp*tp-1, installed as
    the global mesh unless ``set_global=False``. tp shards the GPT layers'
    weights, the paged pool's heads and the step programs; dp is the
    replica-fleet axis."""
    m = ProcessMesh(np.arange(dp * tp).reshape(dp, tp), ["dp", "tp"])
    if set_global:
        set_mesh(m)
    return m


def mesh_axis_size(name, mesh=None) -> int:
    """Size of the axis ``name`` on ``mesh`` (default: the global mesh); 1
    without a mesh or without that axis."""
    m = mesh if mesh is not None else get_mesh()
    if m is None or name not in m.dim_names:
        return 1
    return int(m.get_dim_size(name))


def axis_group(names, mesh=None):
    """This rank's group along the first of ``names`` the mesh (default:
    the global mesh) has with a size above 1, or None."""
    m = mesh if mesh is not None else get_mesh()
    if m is None:
        return None
    for name in (names,) if isinstance(names, str) else names:
        if mesh_axis_size(name, m) > 1:
            return m.get_group(name)
    return None


class SpecLayout:
    """The partition entries of the ("dp", "tp") serving mesh (JAX
    ``mesh.py:294-381``), per tensor dimension: tp rides the qkv / ffn /
    embedding axes, the paged pool shards its leading (kv head) axis, and
    slot-shaped values stay replicated."""

    def __init__(self, dp_axis="dp", tp_axis="tp"):
        self.dp_axis = dp_axis
        self.tp_axis = tp_axis

    def kv_pool(self):
        return (self.tp_axis, None, None, None)

    def heads(self, ndim=4, head_dim=2):
        entries = [None] * ndim
        entries[head_dim] = self.tp_axis
        return tuple(entries)

    def logits(self):
        return (None, self.tp_axis)

    def replicated(self, ndim):
        return (None,) * ndim

    def step_contract(self) -> dict:
        tp = self.tp_axis
        return {
            "state.*qkv_proj.weight": (None, tp),
            "state.*gate_up.weight": (None, tp),
            "state.*out_proj.weight": (tp, None),
            "state.*down.weight": (tp, None),
            "state.embed_tokens.weight": (tp, None),
            "state.*ln*.weight": (),
            "k_pages*": (tp,),
            "v_pages*": (tp,),
            "tables": (),
            "temperatures": (),
            "top_ks": (),
            "rng_key": (),
        }

    def expected_collectives(self) -> dict:
        return {
            "all-reduce":
                "row-parallel / vocab-parallel partial sums (out_proj, "
                "down, embedding lookup) and vocab-sharded sampling "
                "reductions",
            "all-gather":
                "the sampled-logits gather: vocab-sharded [slots, V] "
                "logits gathered to pick the token",
        }
