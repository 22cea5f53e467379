"""The process group of this process — the counterpart of
``paddle_tpu/distributed/env.py`` (``init_parallel_env`` :21-68,
``get_rank``, ``get_world_size``, ``ParallelEnv``).

The JAX package runs one controller process per host and lets GSPMD place
the collectives. The port runs one process per device (SPMD, PyTorch's
idiom and Paddle's own): ``init_parallel_env`` joins this process to a
``torch.distributed`` group of ``world_size`` ranks. It reads what Paddle's
launcher sets — ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``MASTER_ADDR`` / ``MASTER_PORT`` and ``PADDLE_DISTRI_BACKEND`` — unless
the caller passes them.

* On the card (the default): NCCL on ``cuda:<local_rank>``, after
  ``torch.cuda.set_device``. No CUDA device, or NCCL failing to start,
  raises; nothing falls back to the CPU.
* On the CPU, when asked (``device="cpu"`` or
  ``PADDLE_DISTRI_BACKEND=cpu``): gloo. The tests run so.

``init_method`` (a ``file://`` or ``tcp://`` URL) takes the place of the
address; a world of one with neither runs over an in-process store. The
launcher's TCP store and heartbeat belong to ``launch/``, which a later
slice ports.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["init_parallel_env", "is_initialized", "get_rank",
           "get_world_size", "ParallelEnv", "device", "backend"]

_STATE = {"device": None}


def _local_rank(rank):
    for name in ("PADDLE_LOCAL_RANK", "LOCAL_RANK"):
        if name in os.environ:
            return int(os.environ[name])
    return rank % max(1, torch.cuda.device_count())


def init_parallel_env(device=None, init_method=None, world_size=None,
                      rank=None, timeout=None):
    """Join this process to the default process group and return a
    ``ParallelEnv``. ``device``: "cpu" for gloo, else the card ("cuda",
    the default, takes ``cuda:<local_rank>``). ``timeout`` (seconds or a
    ``timedelta``) bounds every collective: a rank left waiting on one
    that never comes raises instead of hanging. A second call returns
    the environment as it is."""
    if dist.is_initialized():
        return ParallelEnv()
    if device is None:
        device = ("cpu" if os.environ.get("PADDLE_DISTRI_BACKEND") == "cpu"
                  else "cuda")
    world = int(world_size if world_size is not None
                else os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    me = int(rank if rank is not None
             else os.environ.get("PADDLE_TRAINER_ID", "0"))
    if isinstance(timeout, (int, float)):
        timeout = datetime.timedelta(seconds=timeout)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_parallel_env: NCCL runs on the card and no CUDA device "
                "is available; pass device='cpu' for gloo on the CPU")
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else _local_rank(me))
        torch.cuda.set_device(dev)
        backend_name = "nccl"
    elif dev.type == "cpu":
        backend_name = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    kwargs = {"timeout": timeout} if timeout is not None else {}
    if backend_name == "nccl":
        kwargs["device_id"] = dev
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '6170')}")
    if init_method is None:
        if world != 1:
            raise ValueError(
                f"init_parallel_env: a world of {world} ranks needs "
                f"MASTER_ADDR / MASTER_PORT or init_method")
        dist.init_process_group(backend_name, store=dist.HashStore(),
                                world_size=1, rank=0, **kwargs)
    else:
        dist.init_process_group(backend_name, init_method=init_method,
                                world_size=world, rank=me, **kwargs)
    _STATE["device"] = dev
    return ParallelEnv()


def is_initialized():
    return dist.is_initialized()


def device() -> torch.device:
    """The device this rank computes on (the CPU before
    ``init_parallel_env``)."""
    return _STATE["device"] or torch.device("cpu")


def backend() -> str:
    """"nccl" or "gloo" (None before ``init_parallel_env``)."""
    return dist.get_backend() if dist.is_initialized() else None


def get_rank(group=None):
    if group is not None:
        return group.rank
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    return dist.get_world_size() if dist.is_initialized() else 1


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def local_rank(self):
        dev = _STATE["device"]
        if dev is not None and dev.type == "cuda":
            return dev.index
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def device_id(self):
        return self.local_rank

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                              "127.0.0.1:6170").split(",")
