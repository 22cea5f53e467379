"""Worker of ``tests/test_torch_launch.py``, started by
``python -m paddle_tpu_torch.distributed.launch --backend gloo``. Imports
torch, numpy and the port only. It joins the process group from the
launcher's environment, then (by its arguments):

* default: a collective over the world (every rank's rank + 1 summed), a
  two-process collective on the group of ranks 0 and 1, a send / receive
  from rank 0 to rank 1, and, with ``--trainstep PATH``, three
  ``DataParallel`` ``TrainStep`` steps of the weights in PATH on this
  rank's rows of the batch there; it writes its record to
  ``<log_dir>/rank<r>.json`` and meets the others at a store barrier;
* ``--fail-once``: the last rank exits 17 on the first attempt;
* ``--rpc``: instead, ``distributed.rpc`` over the launcher's store: each
  rank asks the next for ``pow(rank + 2, 2)`` by worker name and records
  the answer and the worker names, then shuts the agent down.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    import paddle_tpu_torch
    import paddle_tpu_torch.distributed as dist

    paddle_tpu_torch.set_device("cpu")
    torch.set_num_threads(1)
    dist.init_parallel_env(timeout=60)
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == int(os.environ["PADDLE_TRAINERS_NUM"])
    store = dist.env.store()
    assert store is not None, "the launcher's store is not connected"
    attempt = int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))
    if "--fail-once" in sys.argv and rank == world - 1 and attempt == 0:
        os._exit(17)
    rec = {"rank": rank, "world": world, "attempt": attempt,
           "server": store.get("job/server").decode()}
    if "--rpc" in sys.argv:
        from paddle_tpu_torch.distributed import rpc

        rpc.init_rpc(name=f"worker{rank}", rank=rank, world_size=world)
        peer = (rank + 1) % world
        rec["rpc"] = rpc.rpc_sync(f"worker{peer}", pow, args=(rank + 2, 2))
        rec["workers"] = [w.name for w in rpc.get_all_worker_infos()]
        rpc.shutdown()
        _write(rec, rank)
        store.barrier("done", world, timeout=60)
        return
    t = torch.ones(4) * (rank + 1)
    dist.all_reduce(t)
    rec["sum"] = t.tolist()
    pair = dist.new_group([0, 1])
    if rank in (0, 1):
        t2 = torch.full((3,), float(rank + 1))
        dist.all_reduce(t2, group=pair)
        rec["pair_sum"] = t2.tolist()
        payload = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        if rank == 0:
            dist.send(payload, dst=1)
            dist.send(payload + 100, dst=1)
        else:
            got = torch.zeros(2, 3)
            dist.recv(got, src=0)
            first = got.clone()
            dist.recv(got, src=0)
            rec["received"] = [first.tolist(), got.tolist()]
    if "--trainstep" in sys.argv:
        rec["ts_losses"] = _trainstep(sys.argv[sys.argv.index(
            "--trainstep") + 1], rank, world)
    hb = dist.env.heartbeat()
    rec["heartbeats"] = hb.beats if hb is not None else 0
    _write(rec, rank)
    store.barrier("done", world, timeout=60)


def _write(rec, rank):
    out = os.path.join(os.environ["PADDLE_LOG_DIR_OUT"], f"rank{rank}.json")
    with open(out, "w") as f:
        json.dump(rec, f)


def _trainstep(path, rank, world):
    """Three DataParallel TrainStep steps (AdamW) on this rank's rows; the
    mean loss over the ranks."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.jit import TrainStep

    data = np.load(path)
    model = nn.Sequential(nn.Linear(16, 32), nn.GELU(), nn.Linear(32, 16))
    model.set_state_dict({k[2:]: data[k] for k in data.files
                          if k.startswith("w:")})
    opt = optimizer.AdamW(learning_rate=1e-2, parameters=model.parameters())
    loss_fn = nn.MSELoss()
    step = TrainStep(dist.DataParallel(model),
                     lambda o, y: loss_fn(o, y), opt)
    rows = slice(rank * len(data["x"]) // world,
                 (rank + 1) * len(data["x"]) // world)
    x, y = torch.as_tensor(data["x"][rows]), torch.as_tensor(data["y"][rows])
    losses = []
    for _ in range(3):
        loss = step(x, y).float().clone()
        dist.all_reduce(loss, op="avg")
        losses.append(float(loss))
    return losses


if __name__ == "__main__":
    main()
