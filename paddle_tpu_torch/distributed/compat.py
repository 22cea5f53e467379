"""``ParallelMode``, ``get_backend`` and the ``gloo_*`` helpers — the
counterpart of ``paddle_tpu/distributed/compat.py``. In the port gloo is
the CPU process group of ``init_parallel_env(device="cpu")``."""
from __future__ import annotations

import os

from . import env

__all__ = ["ParallelMode", "get_backend", "gloo_init_parallel_env",
           "gloo_barrier", "gloo_release"]


class ParallelMode:
    """The four hybrid axes (Paddle ``fleet/base/topology.py:42``)."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


def get_backend(group=None):
    """The backend serving the group's collectives: "nccl" on the card,
    "gloo" on the CPU (None before ``init_parallel_env``)."""
    import torch.distributed as dist

    if group is not None and group.pg is not None:
        return dist.get_backend(group.pg)
    return env.backend()


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """A CPU (gloo) process group of ``rank_num`` ranks rendezvousing at
    ``server_endpoint`` ("host:port")."""
    host, _, port = server_endpoint.rpartition(":")
    env.init_parallel_env(device="cpu",
                          init_method=f"tcp://{host or '127.0.0.1'}:{port}",
                          world_size=rank_num, rank=rank_id)
    os.environ.setdefault("PADDLE_DISTRI_BACKEND", "cpu")


def gloo_barrier():
    from .collective import barrier

    barrier()


def gloo_release():
    from .collective import destroy_process_group

    destroy_process_group()
