"""``python -m paddle_tpu_torch.distributed.launch`` — the job's entry
point (reference launch/main.py:23: context, controller, watch)::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --backend gloo train.py --epochs 1

Each worker gets ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
``PADDLE_LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` (the process
group's rendezvous), ``PADDLE_MASTER`` (the launcher's store) and
``PADDLE_DISTRI_BACKEND``, and calls
``paddle_tpu_torch.distributed.init_parallel_env()``, which joins the
process group (NCCL on the card, gloo on the CPU), connects to the store
and starts the heartbeat. The launcher's exit code is the pod's.
"""
from __future__ import annotations

import sys

from .context import Context, parse_args
from .controller import CollectiveController

__all__ = ["launch", "main"]


def launch(argv=None):
    args = parse_args(argv)
    ctx = Context(args)
    controller = CollectiveController(ctx)
    try:
        code = controller.watch()
    finally:
        controller.finalize()
    return code


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
