"""``DistributedStrategy``, ``CommunicateTopology`` and
``HybridCommunicateGroup`` — the counterpart of
``paddle_tpu/distributed/fleet/base.py``.

The hybrid group lays the world's ranks on the axes [pp, dp, sharding,
sep, mp] (Paddle ``topology.py:199``, mp fastest) and gives each rank its
coordinate and its process group along every axis (a ``ProcessMesh``
over the world, installed as the global mesh). With the JAX package's
axis order, rank r has the coordinates of JAX's device r. Every degree is
real: pp lays the pipeline stages (``get_stage_id``, the pipe group and a
stage's p2p neighbours ``get_rank_from_stage``), sharding the ZeRO axis
(``get_sharding_parallel_*``), dp, sep and mp as before.
"""
from __future__ import annotations

import collections
import itertools

import numpy as np

from .. import env
from ..mesh import ProcessMesh, set_mesh

__all__ = ["DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "PaddleCloudRoleMaker",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group"]

class DistributedStrategy:
    """The configuration tree of the fields the port honours."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.without_graph_optimization = True

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


class CommunicateTopology:
    """Axis-ordered hybrid topology (Paddle ``topology.py``)."""

    def __init__(self, hybrid_group_names, dims):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self._world = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, name):
        return self._dims[self._parallel_names.index(name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank_coordinate(self, rank):
        return [int(c) for c in np.unravel_index(rank, self._dims)]

    def get_coord(self, rank):
        C = collections.namedtuple("Coord", self._parallel_names)
        return C(*self.get_rank_coordinate(rank))

    def get_rank(self, **coord):
        return int(np.ravel_multi_index(
            [coord[n] for n in self._parallel_names], self._dims))


class HybridCommunicateGroup:
    AXES = ["pp", "dp", "sharding", "sep", "mp"]

    def __init__(self, topology=None, strategy=None):
        if topology is None:
            cfg = (strategy or DistributedStrategy()).hybrid_configs
            dims = [cfg["pp_degree"], cfg["dp_degree"],
                    cfg["sharding_degree"], cfg["sep_degree"],
                    cfg["mp_degree"]]
            topology = CommunicateTopology(self.AXES, dims)
        self._topo = topology
        self._strategy = strategy
        self.nranks = topology.world_size()
        world = env.get_world_size()
        if self.nranks != world:
            raise ValueError(f"the hybrid degrees cover {self.nranks} ranks, "
                             f"the world has {world}")
        self.global_rank = env.get_rank()
        dims = [topology.get_dim(a) for a in self.AXES]
        self.mesh = ProcessMesh(np.arange(self.nranks).reshape(dims),
                                self.AXES)
        set_mesh(self.mesh)
        self._coord = dict(zip(self.AXES,
                               topology.get_rank_coordinate(self.global_rank)))
        self._dp_sep = self._fused_group(("dp", "sep"))
        self._fused: dict = {}
        if self.get_pipe_parallel_world_size() > 1 or (
                self.get_sharding_parallel_world_size() > 1):
            # the groups the pipeline and ZeRO reduce over, made on every
            # rank in one order
            for axes in (("dp", "sharding"), ("pp", "sharding", "mp")):
                self._fused[axes] = self._fused_group(axes)

    def _fused_group(self, axes):
        """This rank's group over the ranks that differ only along
        ``axes`` (every such group made on every rank, in one order); the
        one axis's group where the others have size 1."""
        live = [a for a in axes if self._topo.get_dim(a) > 1]
        if len(live) < 2:
            return self._group(live[0] if live else axes[0])
        from ..collective import new_group

        ids = self.mesh.mesh
        keep = [i for i, a in enumerate(self.AXES) if a in axes]
        rest = [range(s) if i not in keep else [slice(None)]
                for i, s in enumerate(ids.shape)]
        mine = None
        for index in itertools.product(*rest):
            ranks = sorted(int(r) for r in ids[index].reshape(-1))
            g = new_group(ranks, axis_name="_".join(axes))
            if self.global_rank in ranks:
                mine = g
        return mine

    # degrees
    def get_data_parallel_world_size(self):
        return self._topo.get_dim("dp")

    def get_model_parallel_world_size(self):
        return self._topo.get_dim("mp")

    def get_pipe_parallel_world_size(self):
        return self._topo.get_dim("pp")

    def get_sharding_parallel_world_size(self):
        return self._topo.get_dim("sharding")

    def get_sep_parallel_world_size(self):
        return self._topo.get_dim("sep")

    # ranks within an axis
    def get_data_parallel_rank(self):
        return self._coord["dp"]

    def get_model_parallel_rank(self):
        return self._coord["mp"]

    def get_stage_id(self):
        return self._coord["pp"]

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sep_parallel_rank(self):
        return self._coord["sep"]

    # groups
    def _group(self, axis):
        return self.mesh.get_group(axis)

    def get_data_parallel_group(self):
        return self._group("dp")

    def get_model_parallel_group(self):
        return self._group("mp")

    def get_pipe_parallel_group(self):
        return self._group("pp")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_sep_parallel_group(self):
        return self._group("sep")

    def get_dp_sep_parallel_group(self):
        """The ranks that share this rank's model shard: the gradients of
        a replicated parameter are averaged over them."""
        return self._dp_sep

    def get_check_parallel_group(self, sharding=False):
        """The group found-inf is reduced over: the world."""
        from ..collective import get_group

        return get_group()

    def get_fused_group(self, axes):
        """This rank's group over the ranks that differ only along
        ``axes`` (made at construction for ("dp", "sharding") and ("pp",
        "sharding", "mp") when pp or sharding is above 1)."""
        axes = tuple(axes)
        if axes not in self._fused:
            raise KeyError(f"no fused group over {axes}")
        return self._fused[axes]

    def get_sharding_parallel_group_src_rank(self):
        return self._group("sharding").ranks[0]

    def get_pipe_parallel_group_src_rank(self):
        return self._group("pp").ranks[0]

    def get_rank_from_stage(self, stage_id, **kwargs):
        """The global rank of stage ``stage_id`` with this rank's other
        coordinates (overridden by ``kwargs``)."""
        coord = dict(self._coord, pp=int(stage_id))
        coord.update(kwargs)
        return self._topo.get_rank(**coord)

    @property
    def prev_rank(self):
        """The previous stage's rank (the last stage's for stage 0)."""
        p = self.get_pipe_parallel_world_size()
        return self.get_rank_from_stage((self.get_stage_id() - 1) % p)

    @property
    def next_rank(self):
        p = self.get_pipe_parallel_world_size()
        return self.get_rank_from_stage((self.get_stage_id() + 1) % p)

    def get_p2p_groups(self):
        return None

    def get_data_parallel_group_src_rank(self):
        return self._group("dp").ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._group("mp").ranks[0]

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self.get_pipe_parallel_world_size() - 1

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self.get_pipe_parallel_world_size() > 1:
            return "pipeline"
        if self.get_model_parallel_world_size() > 1:
            return "tensor"
        if self.get_sep_parallel_world_size() > 1:
            return "sep"
        if self.get_sharding_parallel_world_size() > 1:
            return "sharding"
        return "data"


class PaddleCloudRoleMaker:
    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective

    def worker_num(self):
        return env.get_world_size()

    def worker_index(self):
        return env.get_rank()

    def is_worker(self):
        return True


_HCG: dict = {"hcg": None}


def set_hybrid_communicate_group(hcg):
    _HCG["hcg"] = hcg


def get_hybrid_communicate_group():
    return _HCG["hcg"]
