"""The launch context: arguments and environment -> the job's
description — the counterpart of
``paddle_tpu/distributed/launch/context.py`` (reference
launch/context/__init__.py and launch/main.py:23's arguments).

One worker process per device. ``--backend`` picks the process group's:
"nccl" (the card, the default) or "gloo" ("cpu" is its alias, the JAX
package's word). The store takes the master port; the process group's own
rendezvous (``MASTER_PORT``) takes the port above it when ``--master`` is
given (a contract every node of a job computes alike), else a free one.
"""
from __future__ import annotations

import argparse
import os
import socket

__all__ = ["Context", "parse_args", "free_port"]


def free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Launch a distributed paddle_tpu_torch job (collective "
                    "controller).",
    )
    p.add_argument("--master", default=None,
                   help="host:port of the rendezvous store (default: start "
                        "one locally)")
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PADDLE_NNODES", "1")),
                   help="number of nodes in the job")
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")),
                   help="rank of this node [0, nnodes)")
    p.add_argument("--nproc_per_node", type=int,
                   default=int(os.environ.get("PADDLE_NPROC_PER_NODE", "1")),
                   help="worker processes to start on this node")
    p.add_argument("--backend",
                   default=os.environ.get("PADDLE_DISTRI_BACKEND", "nccl"),
                   choices=["nccl", "gloo", "cpu"],
                   help="process group backend of the workers: nccl on the "
                        "card, gloo (alias cpu) on the CPU")
    p.add_argument("--log_dir", default=os.environ.get("PADDLE_LOG_DIR", "log"),
                   help="directory for per-worker logs (workerlog.N)")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="restart the pod this many times if a worker fails")
    p.add_argument("--heartbeat_interval", type=float, default=5.0,
                   help="seconds between worker heartbeats to the store")
    p.add_argument("--stop_grace", type=float, default=30.0,
                   help="seconds to wait after SIGTERM before SIGKILL on pod "
                        "teardown (must cover a preemption autocheckpoint)")
    p.add_argument("--heartbeat_timeout", type=float, default=0.0,
                   help="declare a worker hung after this many seconds without "
                        "a heartbeat (0 = disabled)")
    p.add_argument("--run_mode", default="collective", choices=["collective"],
                   help="job mode (only collective is supported)")
    p.add_argument("-m", "--module", action="store_true",
                   help="treat training_script as a module path "
                        "(python -m style) instead of a file")
    p.add_argument("training_script",
                   help="script file or (with -m) module to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


class Context:
    """What the controller needs: the arguments, this node's identity and
    the endpoints."""

    def __init__(self, args):
        self.args = args
        self.nnodes = args.nnodes
        self.node_rank = args.node_rank
        self.nproc_per_node = args.nproc_per_node
        self.world_size = self.nnodes * self.nproc_per_node
        self.backend = "gloo" if args.backend == "cpu" else args.backend
        if args.master:
            host, port = args.master.rsplit(":", 1)
            self.master_host, self.master_port = host, int(port)
            self.spawn_store = self.node_rank == 0
            self.group_port = self.master_port + 1
        else:
            if self.nnodes > 1:
                raise ValueError("--master host:port is required when "
                                 "nnodes > 1")
            self.master_host, self.master_port = "127.0.0.1", free_port()
            self.group_port = free_port()
            self.spawn_store = True
        self.log_dir = args.log_dir

    def rank_of(self, local_rank):
        return self.node_rank * self.nproc_per_node + local_rank

    def worker_env(self, local_rank):
        """The environment of one worker process (the reference's
        ``PADDLE_*`` variables; ``MASTER_*`` is the process group's
        rendezvous)."""
        rank = self.rank_of(local_rank)
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(self.world_size),
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_NNODES": str(self.nnodes),
            "PADDLE_NODE_RANK": str(self.node_rank),
            "MASTER_ADDR": self.master_host,
            "MASTER_PORT": str(self.group_port),
            "PADDLE_MASTER": f"{self.master_host}:{self.master_port}",
            "PADDLE_DISTRI_BACKEND": self.backend,
            "PADDLE_HEARTBEAT_INTERVAL": str(self.args.heartbeat_interval),
            "PADDLE_CURRENT_ENDPOINT":
                f"{self.master_host}:{self.master_port + 2 + rank}",
            "PADDLE_TRAINER_ENDPOINTS": ",".join(
                f"{self.master_host}:{self.master_port + 2 + r}"
                for r in range(self.world_size)),
        })
        return env
