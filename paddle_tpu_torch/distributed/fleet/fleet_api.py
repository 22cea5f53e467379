"""``fleet.init`` / ``distributed_model`` / ``distributed_optimizer`` —
the counterpart of ``paddle_tpu/distributed/fleet/fleet_api.py`` (Paddle
``fleet.py:218``, ``model.py:143-160``)."""
from __future__ import annotations

from .. import env
from .base import (
    DistributedStrategy,
    HybridCommunicateGroup,
    set_hybrid_communicate_group,
)

__all__ = ["Fleet", "fleet_obj", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group"]


class Fleet:
    def __init__(self):
        self._strategy = None
        self._hcg = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        """Join the process group (``init_parallel_env`` from the
        environment, unless already joined) and lay the hybrid group over
        it."""
        self._strategy = strategy or DistributedStrategy()
        env.init_parallel_env()
        self._hcg = HybridCommunicateGroup(strategy=self._strategy)
        set_hybrid_communicate_group(self._hcg)
        return self

    @property
    def strategy(self):
        return self._strategy

    def get_hybrid_communicate_group(self):
        return self._hcg

    def worker_num(self):
        return env.get_world_size()

    def worker_index(self):
        return env.get_rank()

    def is_first_worker(self):
        return env.get_rank() == 0

    def _need_hcg(self):
        if self._hcg is None:
            raise RuntimeError("call fleet.init() first")
        return self._hcg

    def distributed_model(self, model):
        """``PipelineParallel`` (its interleaved form with a
        ``virtual_pp_degree`` above 1) when pp > 1; tensor parallel when
        mp > 1, segment parallel when sep > 1 (each averages the gradients
        over dp x sep at the backward's end), data parallel when dp > 1,
        else the model itself."""
        from ..parallel import DataParallel
        from .meta_parallel import SegmentParallel, TensorParallel
        from .pipeline import (
            PipelineParallel,
            PipelineParallelWithInterleave,
            _vpp_of,
        )

        hcg = self._need_hcg()
        if hcg.get_pipe_parallel_world_size() > 1:
            if _vpp_of(self._strategy) > 1:
                return PipelineParallelWithInterleave(
                    model, hcg, strategy=self._strategy)
            return PipelineParallel(model, hcg, strategy=self._strategy)
        if hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, hcg, strategy=self._strategy)
        if hcg.get_sep_parallel_world_size() > 1:
            return SegmentParallel(model, hcg, strategy=self._strategy)
        if hcg.get_data_parallel_world_size() > 1:
            return DataParallel(model, group=hcg.get_data_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        from .hybrid_optimizer import HybridParallelOptimizer

        return HybridParallelOptimizer(optimizer, self._need_hcg(),
                                       self._strategy)

    def barrier_worker(self):
        from ..collective import barrier

        barrier()


fleet_obj = Fleet()


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO"):
    return fleet_obj.init(role_maker, is_collective, strategy, log_level)


def distributed_model(model):
    return fleet_obj.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return fleet_obj.distributed_optimizer(optimizer, strategy)


def get_hybrid_communicate_group():
    return fleet_obj.get_hybrid_communicate_group()
