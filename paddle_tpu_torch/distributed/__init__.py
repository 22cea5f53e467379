"""``paddle.distributed`` on ``torch.distributed`` — the counterpart of
``paddle_tpu/distributed/__init__.py``, one process per device.

The port holds the process group (``init_parallel_env``), the mesh and
its placements, the collectives, ``DataParallel``, the fleet hybrid group
with tensor, sequence and pipeline parallelism, the dist-tensor API, ZeRO
(``ShardingStage1/2/3``, ``shard_optimizer``, ``shard_scaler``), context
parallelism (ring attention, Ulysses) and the sharded checkpoint
(``checkpoint``: ``save_state_dict`` / ``load_state_dict``). ``spawn`` starts
``nprocs`` processes with ``torch.multiprocessing`` (start method
"spawn"), each calling ``func(*args)`` with ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` / ``MASTER_ADDR`` / ``MASTER_PORT`` set, where
the JAX package calls ``func`` once (:53-57).

``auto_parallel`` (``parallelize`` and its plans, ``Strategy``,
``to_static`` / ``DistModel``, ``to_distributed``), the launcher
(``launch``: ``python -m paddle_tpu_torch.distributed.launch``), its TCP
store (``store.TCPStore``) and ``fleet.elastic`` are the host side of the
same jobs. The names of later slices raise ``NotImplementedError`` naming
their ROADMAP item: ``rpc``, the fleet datasets, ``io`` and the entry
attributes (A5.9).
"""
from __future__ import annotations

import os
import socket

from . import env  # noqa: F401
from .api import (  # noqa: F401
    DistAttr, DistTensor, ReduceType, ShardingStage1, ShardingStage2,
    ShardingStage3, dtensor_from_fn, dtensor_from_local, reshard,
    shard_dataloader, shard_layer, shard_optimizer, shard_scaler,
    shard_tensor, unshard_dtensor,
)
from .collective import (  # noqa: F401
    Group, P2POp, ReduceOp, all_gather, all_gather_object, all_reduce,
    all_to_all_dim, alltoall, alltoall_single, barrier, batch_isend_irecv,
    broadcast, broadcast_object_list, destroy_process_group, gather,
    get_group, irecv, is_available, isend, new_group, recv, reduce,
    reduce_scatter, scatter, scatter_object_list, send, shift, split, wait,
)
from .compat import (  # noqa: F401
    ParallelMode, get_backend, gloo_barrier, gloo_init_parallel_env,
    gloo_release,
)
from .env import (  # noqa: F401
    ParallelEnv, get_rank, get_world_size, init_parallel_env, is_initialized,
)
from .mesh import (  # noqa: F401
    Partial, Placement, ProcessMesh, Replicate, Shard, SpecLayout, auto_mesh,
    get_mesh, mesh_axis_size, serving_mesh, set_mesh,
)
from .parallel import DataParallel  # noqa: F401
from . import context_parallel  # noqa: F401,E402
from .context_parallel import (  # noqa: F401,E402
    RingFlashAttention, SegmentParallel, ring_attention, ulysses_attention,
)
from . import fleet  # noqa: F401,E402
from . import checkpoint  # noqa: F401,E402
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401,E402

all_to_all = alltoall
all_to_all_single = alltoall_single

from . import auto_parallel  # noqa: F401,E402
from .auto_parallel import (  # noqa: F401,E402
    ColWiseParallel, DistModel, LocalLayer, PrepareLayerInput,
    PrepareLayerOutput, RowWiseParallel, SequenceParallelBegin,
    SequenceParallelDisable, SequenceParallelEnable, SequenceParallelEnd,
    SplitPoint, Strategy, ToDistributedConfig, parallelize, to_distributed,
    to_static,
)
from . import launch, store  # noqa: F401,E402
from .store import TCPStore  # noqa: F401,E402

# name -> the ROADMAP item (A5.n) that ports it
_LATER = {
    "InMemoryDataset": "A5.9 (fleet_dataset.py)",
    "QueueDataset": "A5.9 (fleet_dataset.py)",
    "CountFilterEntry": "A5.9 (entry_attr.py)",
    "ProbabilityEntry": "A5.9 (entry_attr.py)",
    "ShowClickEntry": "A5.9 (entry_attr.py)",
    "io": "A5.9 (io.py)",
    "rpc": "A5.9 (rpc/)",
}


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"distributed.{name} is a later slice of the port (ROADMAP "
            f"{_LATER[name]})")
    raise AttributeError(name)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(index, func, args, env_vars):
    os.environ.update(env_vars)
    os.environ["PADDLE_TRAINER_ID"] = str(index)
    os.environ["PADDLE_LOCAL_RANK"] = str(index)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start ``nprocs`` processes (default: one per card; two on the CPU
    when ``PADDLE_DISTRI_BACKEND=cpu`` and none is given) that each call
    ``func(*args)`` with the launcher's variables set, so
    ``init_parallel_env()`` in ``func`` joins them. Returns the
    ``torch.multiprocessing`` context (joined unless ``join=False``)."""
    import torch
    import torch.multiprocessing as mp

    if nprocs == -1:
        nprocs = torch.cuda.device_count() or 2
    env_vars = {"PADDLE_TRAINERS_NUM": str(nprocs),
                "MASTER_ADDR": options.get("ips", "127.0.0.1"),
                "MASTER_PORT": str(options.get("port") or _free_port())}
    if "backend" in options:
        env_vars["PADDLE_DISTRI_BACKEND"] = options["backend"]
    return mp.start_processes(_spawned, args=(func, args, env_vars),
                              nprocs=nprocs, join=join, daemon=daemon,
                              start_method="spawn")
