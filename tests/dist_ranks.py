"""Multi-rank runs of the port on the CPU, for the tests: gloo process
groups in spawned processes. Imports only torch, numpy and
paddle_tpu_torch (never JAX: a forked child of a process running XLA's
threads can hang, so ranks start with the "spawn" method).

``run_ranks(bodies, world, inputs)`` starts ``world`` processes that join
one gloo group (a ``file://`` rendezvous in a fresh directory: no port to
race for under parallel test workers), each running the named bodies of
this module in order: ``body(inputs) -> result`` (numpy arrays, numbers,
dicts of them). It returns ``[{body: result} for each rank]``. Every
collective has a 60 s timeout and the run a deadline, so a rank that
raises leaves the others failing in their next collective instead of
hanging; the error reported is the first rank's traceback
(``RankFailed``). A body may live in another module of the tests
(``"module:function"``). One spawn runs at a time across the processes
of a test run (a lock file in the temp directory), its ranks at nice 10.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

COLLECTIVE_TIMEOUT_S = 60
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class RankFailed(RuntimeError):
    """A rank raised; ``rank`` and ``trace`` say which and where."""

    def __init__(self, rank, trace):
        super().__init__(f"rank {rank} failed:\n{trace}")
        self.rank = rank
        self.trace = trace


def _entry(rank, world, store, bodies, inputs, out_dir, timeout_s):
    result, err, t_err = {}, None, None
    try:
        sys.path.insert(0, _ROOT)
        # below the test workers' priority: a spawn's ranks must not slow
        # the calls other workers time against the per-test budget
        os.nice(10)
        import torch

        from paddle_tpu_torch.distributed import env

        torch.set_num_threads(1)
        env.init_parallel_env(device="cpu", init_method=f"file://{store}",
                              world_size=world, rank=rank,
                              timeout=datetime.timedelta(seconds=timeout_s))
        for name in bodies:
            result[name] = _body(name)(inputs)
        # a rank that is done must not exit (closing its sockets) while
        # another still connects to a group the bodies made last
        from paddle_tpu_torch.distributed import barrier

        barrier()
    except BaseException:
        err, t_err = traceback.format_exc(), time.time()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((result, err, t_err), f)
    if err is None:
        from paddle_tpu_torch.distributed import destroy_process_group

        destroy_process_group()


def _body(name):
    """A body of this module, or ``"module:function"`` of another module
    of the tests (which, like this one, imports torch and the port
    only)."""
    if ":" not in name:
        return globals()[name]
    import importlib

    mod, fn = name.split(":")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    return getattr(importlib.import_module(mod), fn)


def run_ranks(bodies, world, inputs=None, deadline_s=150.0,
              timeout_s=COLLECTIVE_TIMEOUT_S):
    import fcntl

    # one spawn at a time across the test workers: the ranks of several
    # files at once would crowd the cores the other workers' calls are
    # timed on (the per-test budget guard)
    lock_path = os.path.join(tempfile.gettempdir(),
                             "paddle_tpu_torch_dist_ranks.lock")
    with open(lock_path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _run_ranks(bodies, world, inputs, deadline_s, timeout_s)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _run_ranks(bodies, world, inputs, deadline_s, timeout_s):
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="dist_ranks_")
    try:
        ctx = mp.start_processes(
            _entry, args=(world, os.path.join(tmp, "store"), list(bodies),
                          inputs or {}, tmp, timeout_s),
            nprocs=world, join=False, start_method="spawn")
        t_end = time.monotonic() + deadline_s
        while not all(not p.is_alive() for p in ctx.processes):
            if time.monotonic() > t_end:
                for p in ctx.processes:
                    p.kill()
                break
            time.sleep(0.05)
        for p in ctx.processes:
            p.join(5)
        results, errors = [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append((float("inf"), r, f"rank {r} exited "
                               f"{ctx.processes[r].exitcode} without a "
                               f"result (deadline {deadline_s} s)"))
                results.append({})
                continue
            with open(path, "rb") as f:
                res, err, t_err = pickle.load(f)
            results.append(res)
            if err is not None:
                errors.append((t_err, r, err))
        if errors:
            # the root cause is the first rank to fail: the others fail
            # after it, in the collective it left them waiting in
            raise RankFailed(*min(errors)[1:])
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------------ helpers
def _npy(t):
    t = getattr(t, "_value", t)
    return t.detach().float().cpu().numpy().copy()


def _me():
    from paddle_tpu_torch.distributed import env

    return env.get_rank(), env.get_world_size()


# ------------------------------------------------------- the deadlock probe
def body_raise_on_rank1(inputs):
    """Rank 1 raises before a collective rank 0 then waits in."""
    import torch

    from paddle_tpu_torch import distributed as dist

    rank, _ = _me()
    if rank == 1:
        raise ValueError("planted failure on rank 1")
    dist.all_reduce(torch.ones(4))
    return True


# -------------------------------------------------------------- collectives
def _collectives_on(g, x, tag):
    """Every collective of ``distributed.collective`` over group ``g``,
    rank ``g.rank`` holding ``x[g.rank]`` of the [n, ...] array ``x``."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.tensor import Tensor

    n, me = g.nranks, g.rank
    out = {}
    mine = lambda: torch.tensor(x[me])          # noqa: E731
    for op in ("sum", "max", "min", "prod", "avg"):
        t = mine()
        dist.all_reduce(t, op=op, group=g)
        out[f"all_reduce_{op}"] = t.numpy()
    t = Tensor(mine())
    assert dist.all_reduce(t, group=g) is t      # the Tensor, in place
    out["all_reduce_tensor"] = t._value.numpy()
    t = mine()
    dist.reduce(t, dst=g.ranks[0], group=g)
    out["reduce"] = t.numpy()
    t = mine()
    dist.broadcast(t, src=g.ranks[n - 1], group=g)
    out["broadcast"] = t.numpy()
    lst = []
    dist.all_gather(lst, Tensor(mine()), group=g)
    out["all_gather"] = np.stack([v._value.numpy() for v in lst])
    out["all_gather_axis"] = dist.all_gather(None, mine()[None], group=g,
                                             axis=0).numpy()
    lst = []
    dist.gather(mine(), lst, dst=g.ranks[0], group=g)
    out["gather"] = np.stack([v.numpy() for v in lst])
    # scatter: the source's list holds 10 * i + 100 * source rank
    t = torch.zeros_like(mine())
    src_list = [mine() * 0 + 10.0 * i + 100.0 * me for i in range(n)]
    dist.scatter(t, src_list, src=g.ranks[0], group=g)
    out["scatter"] = t.numpy()
    # reduce_scatter: a list of n values, and one value cut along dim 0
    t = torch.zeros_like(mine())
    dist.reduce_scatter(t, [mine() * (i + 1) for i in range(n)], group=g)
    out["reduce_scatter_list"] = t.numpy()
    whole = torch.stack([mine() * (i + 1) for i in range(n)])
    t = torch.zeros_like(whole[:1])
    dist.reduce_scatter(t, whole, group=g)
    out["reduce_scatter_tiled"] = t.numpy()
    # alltoall: value i of rank r is x[r] * (i + 1) + i
    outs = []
    dist.alltoall(outs, [mine() * (i + 1) + i for i in range(n)], group=g)
    out["alltoall"] = np.stack([v.numpy() for v in outs])
    src = torch.tensor(np.concatenate([x[me] * (i + 1) + i
                                       for i in range(n)]))
    dst = torch.empty_like(src)
    dist.alltoall_single(dst, src, group=g)
    out["alltoall_single"] = dst.numpy()
    # uneven splits: rank r sends j + 1 rows of r * 10 + j to rank j
    rows = x.shape[-1]
    send = torch.cat([torch.full((j + 1, rows), float(me * 10 + j))
                      for j in range(n)])
    recv = Tensor(torch.empty(0, rows))
    dist.alltoall_single(recv, send, in_split_sizes=[j + 1 for j in range(n)],
                         out_split_sizes=[me + 1] * n, group=g)
    out["alltoall_single_uneven"] = recv._value.numpy()
    out["shift"] = dist.shift(mine(), 1, group=g).numpy()
    out["shift_back"] = dist.shift(mine(), -1, group=g).numpy()
    # point to point: a ring by send/recv, then by isend/irecv, then
    # both directions in one batch
    nxt, prv = g.ranks[(me + 1) % n], g.ranks[(me - 1) % n]
    t = torch.zeros_like(mine())
    if me % 2 == 0:
        dist.send(mine(), dst=nxt, group=g)
        dist.recv(t, src=prv, group=g)
    else:
        dist.recv(t, src=prv, group=g)
        dist.send(mine(), dst=nxt, group=g)
    out["send_recv"] = t.numpy()
    t = torch.zeros_like(mine())
    works = [dist.isend(mine(), dst=nxt, group=g),
             dist.irecv(t, src=prv, group=g)]
    for w in works:
        w.wait()
    out["isend_irecv"] = t.numpy()
    a, b = torch.zeros_like(mine()), torch.zeros_like(mine())
    ops = [dist.P2POp(dist.isend, mine(), nxt, g),
           dist.P2POp(dist.irecv, a, prv, g),
           dist.P2POp(dist.isend, mine() * 2, prv, g),
           dist.P2POp(dist.irecv, b, nxt, g)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    out["batch_p2p"] = np.stack([a.numpy(), b.numpy()])
    objs = [{"from": me}] if me == n - 1 else [None]
    dist.broadcast_object_list(objs, src=g.ranks[n - 1], group=g)
    out["broadcast_object"] = objs[0]["from"]
    got = []
    dist.all_gather_object(got, ("r", me), group=g)
    out["all_gather_object"] = got
    got = []
    dist.scatter_object_list(got, [f"o{i}" for i in range(n)]
                             if me == 0 else None, src=g.ranks[0], group=g)
    out["scatter_object"] = got[0]
    dist.barrier(group=g)
    dist.wait(Tensor(mine()), group=g)
    return {f"{tag}_{k}": v for k, v in out.items()}


def body_collectives(inputs):
    """Over the world (4 ranks) and over the pairs {0, 1}, {2, 3} of a 2x2
    mesh, every rank with its row of the same input."""
    from paddle_tpu_torch import distributed as dist

    out = {}
    world = dist.new_group()
    out.update(_collectives_on(world, inputs["x4"], "n4"))
    mesh = dist.ProcessMesh([[0, 1], [2, 3]], ["a", "b"])
    out.update(_collectives_on(mesh.get_group("b"), inputs["x2"], "n2"))
    out["pair_ranks"] = mesh.get_group("b").ranks
    out["group_axis"] = mesh.get_group("b").axis_name
    out["backend"] = dist.get_backend()
    return out


# ------------------------------------------------------------ data parallel
def _mlp(state):
    """The port's Linear(16, 32) -> ReLU -> Linear(32, 4) with the JAX
    model's weights."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import from_paddle_tpu_state, nn

    P.set_device("cpu")
    net = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
    return from_paddle_tpu_state(state, net)


def _grads(net):
    import torch

    return {k: _npy(p.grad) for k, p in
            torch.nn.Module.named_parameters(net)}


def _rows(a, counts):
    """This rank's rows of ``a`` when rank r holds ``counts[r]`` of them."""
    rank, _ = _me()
    lo = sum(counts[:rank])
    return a[lo:lo + counts[rank]]


def body_data_parallel(inputs):
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.nn import functional as F

    rank, world = _me()
    out = {}
    T = lambda a: P.to_tensor(a)                 # noqa: E731
    # outputs: each rank's rows of the batch
    dp = dist.DataParallel(_mlp(inputs["s0"]))
    x = inputs["x16"]
    out["shard_out"] = _npy(dp(T(_rows(x, [8] * world))))
    # the gradients of the global batch's mean loss, an even split
    net = _mlp(inputs["s7"])
    dp = dist.DataParallel(net)
    xs, ys = _rows(x, [8] * world), _rows(inputs["y16"], [8] * world)
    loss = dp.scale_loss(F.cross_entropy(dp(T(xs)), T(ys)))
    loss.backward()
    dp.apply_collective_grads()
    out["grads"] = _grads(net)
    out["syncs"] = dp.syncs
    # the same under no_sync: local gradients, averaged on request
    net = _mlp(inputs["s7"])
    dp = dist.DataParallel(net)
    with dp.no_sync():
        F.cross_entropy(dp(T(xs)), T(ys)).backward()
    out["local_grads"] = _grads(net)
    dp.apply_collective_grads()
    out["no_sync_grads"] = _grads(net)
    # uneven: 3 rows on rank 0, 2 on rank 1
    net = _mlp(inputs["s4"])
    dp = dist.DataParallel(net)
    counts = [3, 2]
    x5, y5 = _rows(inputs["x5"], counts), _rows(inputs["y5"], counts)
    o = dp(T(x5))
    out["uneven_out"] = _npy(o)
    F.cross_entropy(o, T(y5)).backward()
    out["uneven_grads"] = _grads(net)
    # ten SGD steps on the halves of a 32-row batch
    net = _mlp(inputs["s3"])
    dp = dist.DataParallel(net)
    opt = P.optimizer.SGD(0.5, parameters=dp.parameters())
    x32, y32 = _rows(inputs["x32"], [16] * world), _rows(inputs["y32"],
                                                         [16] * world)
    losses = []
    for _ in range(10):
        loss = F.cross_entropy(dp(T(x32)), T(y32))
        loss.backward()
        opt.step()
        opt.clear_grad()
        t = loss._value.detach().clone()
        dist.all_reduce(t, op="avg")
        losses.append(float(t))
    out["losses"] = losses
    out["state_keys"] = sorted(dp.state_dict()) == sorted(net.state_dict())
    # three TrainStep (SGD) steps under DataParallel on an uneven split
    net = _mlp(inputs["s4"])
    dp = dist.DataParallel(net)
    opt = P.optimizer.SGD(0.1, parameters=dp.parameters())
    step = P.jit.TrainStep(dp, lambda o, y: F.cross_entropy(o, y), opt)
    counts = [4, 2]
    x6, y6 = _rows(inputs["x6"], counts), _rows(inputs["y6"], counts)
    out["step_losses"] = [float(step(T(x6), T(y6)))
                          for _ in range(3)]
    out["step_params"] = {k: _npy(p) for k, p in
                          torch.nn.Module.named_parameters(net)}
    out["step_syncs"] = dp.syncs
    # shard_dataloader: each rank its half of every batch
    X, Y = inputs["x64"], inputs["y64"]

    class DS(P.io.Dataset):
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return X[i], Y[i]

    mesh = dist.ProcessMesh([[0], [1]], dim_names=["dp", "mp"])
    dl = P.io.DataLoader(DS(), batch_size=16)
    sdl = dist.shard_dataloader(dl, meshes=[mesh], shard_dims="dp")
    xb, yb = next(iter(sdl))
    out["loader"] = (len(sdl) == len(dl), _npy(xb), _npy(yb))
    return out


# --------------------------------------------------------- tensor parallel
def _tp_model(inputs, state=None):
    from paddle_tpu_torch import from_paddle_tpu_state
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(**inputs["config"])
    return from_paddle_tpu_state(state or inputs["state"], cfg,
                                 device="cpu"), cfg


def _named_grads(model):
    return {k.removeprefix("gpt."): _npy(p.grad)
            for k, p in model.named_parameters()}


def body_tensor_parallel(inputs):
    """fleet.init(mp = world): the GPT's loss, gathered logits and gradients
    (rank shards), a contiguous-cut control, three TrainStep steps of AdamW
    with the hybrid global-norm clip, and the layers on their own."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    rank, world = _me()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["mp_degree"] = world
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    out = {"mp_rank": hcg.get_model_parallel_rank(),
           "mp_world": hcg.get_model_parallel_world_size(),
           "mode": hcg.get_parallel_mode()}
    ids = torch.as_tensor(inputs["ids"])
    labels = torch.as_tensor(inputs["labels"])
    for name in ("tiny", "gqa"):
        sub = dict(inputs, config=inputs["configs"][name],
                   state=inputs["states"][name])
        model, cfg = _tp_model(sub)
        out[f"{name}_tp_group"] = model.tp_group.ranks
        out[f"{name}_qkv_shape"] = tuple(
            model.gpt.blocks[0].attn.qkv_proj.weight.shape)
        logits, loss = model(ids, labels=labels)
        loss.backward()
        out[f"{name}_loss"] = float(loss)
        out[f"{name}_local_vocab"] = logits.shape[-1]
        out[f"{name}_logits"] = _npy(model.gather_logits(logits))
        out[f"{name}_grads"] = _named_grads(model)
    # the control: qkv cut in contiguous columns, not per head group
    from paddle_tpu_torch.bridge import shard_state

    cfg_kw, state = inputs["configs"]["tiny"], inputs["states"]["tiny"]
    model, cfg = _tp_model(dict(inputs, config=cfg_kw, state=state))
    local = shard_state(state, cfg, world, rank)
    with torch.no_grad():
        for k, p in model.named_parameters():
            key = k[len("gpt."):]
            v = local[key]
            if key.endswith("qkv_proj.weight"):
                v = np.split(np.asarray(state[key]), world, axis=-1)[rank]
            p.copy_(torch.as_tensor(np.ascontiguousarray(v)))
    out["contiguous_logits"] = _npy(model.gather_logits(model(ids)))
    # three TrainStep steps: AdamW, clipped by the global norm over mp
    model, cfg = _tp_model(dict(inputs, config=cfg_kw, state=state))
    opt = topt.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                     weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(0.5))
    hopt = fleet.distributed_optimizer(opt)
    tmodel = fleet.distributed_model(model)
    out["clip"] = type(opt._grad_clip).__name__
    step = TrainStep(tmodel, lambda logits, loss: loss, hopt)
    out["step_losses"] = [float(step(ids, labels)) for _ in range(3)]
    out["step_params"] = {k.removeprefix("gpt."): _npy(p)
                          for k, p in model.named_parameters()}
    # the layers alone
    out.update(_tp_layers(inputs["layers"]))
    # the RNG streams: global the same on every rank, local not
    from paddle_tpu_torch.framework import random as trandom

    trandom.model_parallel_random_seed(7)
    tr = trandom.get_rng_state_tracker()
    with tr.rng_state("global_seed"):
        g = torch.rand(4, generator=trandom.default_generator("cpu"))
    with tr.rng_state("local_seed"):
        l = torch.rand(4, generator=trandom.default_generator("cpu"))
    out["rng"] = (g.numpy(), l.numpy())
    # pp above 1 is taken: two stages over the two ranks
    s = fleet.DistributedStrategy()
    s.hybrid_configs["pp_degree"] = 2
    pp_hcg = fleet.HybridCommunicateGroup(strategy=s)
    out["pp_stage"] = pp_hcg.get_stage_id()
    out["pp_mode"] = pp_hcg.get_parallel_mode()
    return out


def body_hybrid_dp_mp(inputs):
    """fleet.init(dp = 2, mp = 2) over four ranks, each dp rank its half of
    the batch and each mp rank its shards, through fleet's model and
    optimizer: the gradients of one backward (synced by the wrapper over
    dp), then three TrainStep steps of SGD."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(dp_degree=2, mp_degree=2)
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    d = hcg.get_data_parallel_rank()
    half = inputs["ids"].shape[0] // 2
    ids = torch.as_tensor(inputs["ids"][d * half:(d + 1) * half])
    labels = torch.as_tensor(inputs["labels"][d * half:(d + 1) * half])
    out = {"dp_rank": d, "mp_rank": hcg.get_model_parallel_rank(),
           "dp_sep_ranks": hcg.get_dp_sep_parallel_group().ranks}
    model, _ = _tp_model(inputs)
    tmodel = fleet.distributed_model(model)
    out["wrapper"] = type(tmodel).__name__
    _, loss = tmodel(ids, labels=labels)
    loss.backward()
    out["grads"] = _named_grads(model)
    model, _ = _tp_model(inputs)
    tmodel = fleet.distributed_model(model)
    hopt = fleet.distributed_optimizer(
        topt.SGD(learning_rate=inputs["lr"], parameters=model.parameters()))
    step = TrainStep(tmodel, lambda logits, loss: loss, hopt)
    losses = []
    for _ in range(3):
        loss = step(ids, labels).detach().clone()
        dist.all_reduce(loss, op="avg", group=hcg.get_data_parallel_group())
        losses.append(float(loss))
    out["step_losses"] = losses
    out["step_syncs"] = tmodel.syncs
    out["step_params"] = {k.removeprefix("gpt."): _npy(p)
                          for k, p in model.named_parameters()}
    return out


def _tp_layers(L):
    """VocabParallelEmbedding, ColumnParallelLinear (gathered output),
    RowParallelLinear (whole input) and ParallelCrossEntropy on this rank's
    shards of the given weights: outputs and input / weight gradients."""
    import torch

    from paddle_tpu_torch.distributed.fleet import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding,
    )

    rank, world = _me()
    out = {}
    emb = VocabParallelEmbedding(32, 8)
    with torch.no_grad():
        emb.weight.copy_(torch.as_tensor(
            np.split(L["emb_w"], world, 0)[rank]))
    e = emb(torch.as_tensor(L["ids"]))
    (e * torch.as_tensor(L["emb_ct"])).sum().backward()
    out["emb_out"] = _npy(e)
    out["emb_wgrad"] = _npy(emb.weight.grad)
    col = ColumnParallelLinear(16, 32, gather_output=True)
    row = RowParallelLinear(32, 16, input_is_parallel=False)
    with torch.no_grad():
        col.weight.copy_(torch.as_tensor(np.split(L["w1"], world, 1)[rank]))
        col.bias.copy_(torch.as_tensor(np.split(L["b1"], world)[rank]))
        row.weight.copy_(torch.as_tensor(np.split(L["w2"], world, 0)[rank]))
        row.bias.copy_(torch.as_tensor(L["b2"]))
    x = torch.as_tensor(L["x"]).requires_grad_(True)
    y = row(col(x))
    (y ** 2).sum().backward()
    out["mlp_out"] = _npy(y)
    out["mlp_xgrad"] = _npy(x.grad)
    out["mlp_grads"] = [_npy(col.weight.grad), _npy(col.bias.grad),
                        _npy(row.weight.grad), _npy(row.bias.grad)]
    ce = ParallelCrossEntropy(ignore_index=-100)
    lg = torch.as_tensor(np.split(L["logits"], world, -1)[rank])
    lg.requires_grad_(True)
    loss = ce(lg, torch.as_tensor(L["labels"]))
    loss.mean().backward()
    out["ce_loss"] = _npy(loss)
    out["ce_grad"] = _npy(lg.grad)
    return out


# ------------------------------------------------------ context parallelism
def _seq_shard(a, g):
    import torch

    return torch.as_tensor(a).chunk(g.nranks, dim=1)[g.rank].contiguous()


def _cp_case(fn, q, k, v, g, **kw):
    """fn on this rank's sequence shards: (output shard, gradient shards
    of sum(out ** 2) summed over the ranks)."""
    qs, ks, vs = (_seq_shard(a, g).requires_grad_(True) for a in (q, k, v))
    out = fn(qs, ks, vs, group=g, **kw)
    (out ** 2).sum().backward()
    return _npy(out), [_npy(t.grad) for t in (qs, ks, vs)]


def body_context_parallel(inputs):
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.context_parallel import (
        RingFlashAttention, ring_attention, split_sequence,
        ulysses_attention,
    )
    from paddle_tpu_torch.distributed.fleet import (
        ColumnSequenceParallelLinear, RowSequenceParallelLinear,
    )
    from paddle_tpu_torch.distributed.fleet import sequence_parallel_utils \
        as spu

    mesh = dist.ProcessMesh([[0, 1], [2, 3]], ["dp", "sep"])
    groups = {4: dist.new_group(), 2: mesh.get_group("sep")}
    q, k, v = inputs["q"], inputs["k"], inputs["v"]
    out = {}
    for n, g in groups.items():
        for causal in (False, True):
            out[f"ring_{n}_{causal}"] = _cp_case(ring_attention, q, k, v, g,
                                                 causal=causal)
            out[f"ulysses_{n}_{causal}"] = _cp_case(
                ulysses_attention, q, k, v, g, causal=causal)
        out[f"split_{n}"] = _npy(split_sequence(torch.as_tensor(
            inputs["seq"]), group=g))
    gq = inputs["gqa"]
    out["ring_gqa"] = _cp_case(ring_attention, *gq, groups[4], causal=True)
    attn = RingFlashAttention(causal=True, group=groups[2])
    out["ring_facade"] = _npy(attn(*(_seq_shard(a, groups[2])
                                     for a in (q, k, v))))
    # Megatron sequence parallelism over the world (mp = 4)
    g = groups[4]
    S = inputs["sp"]
    col = ColumnSequenceParallelLinear(16, 32, has_bias=True, mp_group=g)
    row = RowSequenceParallelLinear(32, 16, has_bias=True, mp_group=g)
    with torch.no_grad():
        col.weight.copy_(torch.as_tensor(np.split(S["w1"], 4, 1)[g.rank]))
        col.bias.copy_(torch.as_tensor(np.split(S["b1"], 4)[g.rank]))
        row.weight.copy_(torch.as_tensor(np.split(S["w2"], 4, 0)[g.rank]))
        row.bias.copy_(torch.as_tensor(S["b2"]))
    xs = _seq_shard(S["x"], g).requires_grad_(True)
    y = row(col(xs))
    (y ** 2).sum().backward()
    out["sp"] = (_npy(y), _npy(xs.grad),
                 [_npy(p.grad) for p in (col.weight, col.bias, row.weight,
                                         row.bias)])
    # the same pair under the hybrid gradient sync: the marked bias summed
    # over mp, the sharded weights left as they are
    from paddle_tpu_torch.distributed.parallel import GradientSync

    for p in (col.weight, col.bias, row.weight, row.bias):
        p.grad = None
    pair = GradientSync(torch.nn.Sequential(col, row), group=None,
                        sp_group=g)
    (pair(xs.detach()) ** 2).sum().backward()
    out["sp_synced"] = [_npy(p.grad) for p in (col.weight, col.bias,
                                               row.weight, row.bias)]
    x = torch.as_tensor(inputs["explicit"])
    shard = spu.scatter(x, seq_dim=1, group=g)
    out["sp_explicit"] = (tuple(shard.shape),
                          _npy(spu.all_gather(shard, seq_dim=1, group=g)))
    return out


def _cp_net(w, attn, heads):
    """The context-parallel training case's model: a qkv projection,
    causal attention over the sep group (``attn``: ring or Ulysses), an
    output projection; weights [in, out] from the test's arrays."""
    import torch

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.ParameterList(
                torch.nn.Parameter(torch.as_tensor(a).clone()) for a in w)

        def forward(self, x):
            w1, b1, w2, b2 = self.w
            B, s, _ = x.shape
            qkv = (x @ w1 + b1).reshape(B, s, 3, heads, -1)
            o = attn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=True)
            return o.reshape(B, s, -1) @ w2 + b2

    return Net()


def body_sep_training(inputs):
    """fleet.init(dp = 2, sep = 2) over four ranks, rank (d, s) holding
    rows d and sequence segment s: for ring and Ulysses attention, the
    gradients of one backward through fleet's SegmentParallel (synced over
    dp x sep), then three TrainStep steps of SGD."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.context_parallel import (
        ring_attention, ulysses_attention,
    )
    from paddle_tpu_torch.jit import TrainStep

    C = inputs["sep_case"]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(dp_degree=2, sep_degree=2)
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    d, s = hcg.get_data_parallel_rank(), hcg.get_sep_parallel_rank()
    cut = lambda a: torch.as_tensor(np.ascontiguousarray(    # noqa: E731
        np.split(np.split(a, 2, 0)[d], 2, 1)[s]))
    x, y = cut(C["x"]), cut(C["y"])

    def loss_fn(logits, label):
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), label.reshape(-1))

    out = {"coord": (d, s), "dp_sep_ranks":
           hcg.get_dp_sep_parallel_group().ranks}
    for name, attn in (("ring", ring_attention),
                       ("ulysses", ulysses_attention)):
        net = fleet.distributed_model(_cp_net(C["w"], attn, C["heads"]))
        out["wrapper"] = type(net).__name__
        loss_fn(net(x), y).backward()
        out[f"{name}_grads"] = [_npy(p.grad) for p in net._layers.w]
        net = fleet.distributed_model(_cp_net(C["w"], attn, C["heads"]))
        opt = fleet.distributed_optimizer(
            topt.SGD(learning_rate=C["lr"], parameters=net.parameters()))
        step = TrainStep(net, loss_fn, opt)
        losses = []
        for _ in range(3):
            loss = step(x, y).detach().clone()
            dist.all_reduce(loss, op="avg")
            losses.append(float(loss))
        out[f"{name}_losses"] = losses
        out[f"{name}_params"] = [_npy(p) for p in net._layers.w]
        out[f"{name}_syncs"] = net.syncs
    return out


# --------------------------------------------------- tensor-parallel serving
def _paged_tokens(model, prompts, new, tp_group=None, num_blocks=24,
                  **gen_kw):
    """generate_paged over a fresh pool (block 8, ``num_blocks`` blocks,
    f32), the prompts right-padded; the JAX test's ``_paged_tokens``."""
    from paddle_tpu_torch.inference import PagedKVCache

    c = model.config
    cache = PagedKVCache(c.num_layers, c.num_kv_heads,
                         c.hidden_size // c.num_heads, block_size=8,
                         num_blocks=num_blocks, dtype="float32",
                         device="cpu", tp_group=tp_group)
    plens = np.asarray([len(p) for p in prompts])
    batch = np.zeros((len(prompts), int(plens.max())), np.int64)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    nb = max(cache.blocks_for(int(p) + new) for p in plens)
    for i in range(len(prompts)):
        cache.reserve(i, int(plens[i]) + new)
    tbl = np.stack([cache.block_table(i, pad_to=nb)
                    for i in range(len(prompts))])
    toks = model.generate_paged(batch, plens, cache, tbl,
                                max_new_tokens=new, **gen_kw)
    return np.asarray(toks), cache


def body_mesh_serving(inputs):
    """serving_mesh(dp=1, tp=world): generate_paged greedy and sampled on
    the head-sharded pool, the same calls on one rank's whole model, and
    the continuous scheduler in lockstep (rank 0 serves the requests)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import from_paddle_tpu_state
    from paddle_tpu_torch.inference import (
        ContinuousGenerateBatchingPredictor, PagedKVCache,
    )
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.observability.metrics import render_prometheus

    rank, world = _me()
    cfg = GPTConfig(**inputs["config"])
    prompts, new = inputs["prompts"], inputs["new"]
    sampled = inputs["sampled"]
    out = {}
    # one rank's whole model: the tp = 1 reference, built before the mesh
    whole = from_paddle_tpu_state(inputs["state"], cfg, device="cpu")
    whole.eval()
    assert whole.tp_group is None
    out["tp1_greedy"], c1 = _paged_tokens(whole, prompts, new)
    out["tp1_sampled"], _ = _paged_tokens(whole, prompts, new, **sampled)
    out["tp1_sharded"] = c1.tp_sharded
    dist.serving_mesh(dp=1, tp=world)
    model = from_paddle_tpu_state(inputs["state"], cfg, device="cpu")
    model.eval()
    out["tp"] = model.tp_group.nranks
    out["greedy"], cache = _paged_tokens(model, prompts, new)
    out["sampled"], _ = _paged_tokens(model, prompts, new, **sampled)
    # the first sampled token of one prompt in many rows (independent
    # uniforms per row): the draws the test holds to the cut-softmax law
    chi = inputs["chi"]
    toks, _ = _paged_tokens(model, [chi["prompt"]] * chi["n"], 1,
                            num_blocks=chi["n"], temperature=chi["T"],
                            top_k=chi["top_k"], seed=chi["seed"])
    out["chi_tokens"] = toks[:, -1]
    out["pool"] = (cache.tp_sharded, tuple(cache.k_pages[0].shape),
                   cache.per_chip_pool_bytes(), cache.pool_bytes(),
                   c1.pool_bytes())
    # the continuous scheduler: every rank builds it, rank 0 serves
    kw = dict(inputs["sched_kw"])
    pool = PagedKVCache(cfg.num_layers, cfg.num_kv_heads,
                        cfg.hidden_size // cfg.num_heads,
                        block_size=kw.pop("block_size"),
                        num_blocks=kw.pop("num_blocks"), dtype="float32",
                        device="cpu")
    pred = ContinuousGenerateBatchingPredictor(model, kv_cache=pool,
                                               device="cpu", **kw)
    out["sched_pool"] = tuple(pred.kv_cache.k_pages[0].shape)
    prom = render_prometheus(pred.metrics.registry)
    out["per_chip_gauge"] = [
        float(line.rsplit(" ", 1)[1]) for line in prom.splitlines()
        if line.startswith("paddle_kv_pool_per_chip_bytes")]
    out["sched_pool_bytes"] = pred.kv_cache.per_chip_pool_bytes()
    if rank == 0:
        out["sched"] = [np.asarray(pred.infer(p, timeout=120))
                        for p in inputs["sched_prompts"]]
        pred.close()
    else:
        try:
            pred.infer(inputs["sched_prompts"][0])
            out["follower_refuses"] = False
        except RuntimeError:
            out["follower_refuses"] = True
        pred.close()                    # returns once rank 0 closed
        out["follower_runs"] = pred.follower_runs
    return out


# ------------------------------------------------------------ dist tensors
def body_dist_api(inputs):
    """shard_tensor / reshard / unshard / dtensor_from_* over a 2 x 2 mesh
    ("x", "y"), and a Layer's parameter cut in place."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch import distributed as dist

    rank, _ = _me()
    mesh = dist.ProcessMesh([[0, 1], [2, 3]], ["x", "y"])
    S, R = dist.Shard, dist.Replicate
    a = torch.as_tensor(inputs["a"])
    out = {}
    t = dist.shard_tensor(a, mesh, [S(0), R()])
    out["s0"] = _npy(t)
    t2 = dist.shard_tensor(a, mesh, [S(0), S(1)])
    out["s01"] = _npy(t2)
    out["global_shape"] = t2.global_shape
    out["unshard"] = _npy(dist.unshard_dtensor(t2))
    out["reshard_s1"] = _npy(dist.reshard(t, mesh, [R(), S(1)]))
    part = dist.dtensor_from_local(a * (rank + 1), mesh,
                                   [dist.Partial(), R()])
    out["p2r"] = _npy(dist.reshard(part, mesh, [R(), R()]))
    out["from_fn"] = _npy(dist.dtensor_from_fn(torch.ones, mesh,
                                               [S(0), R()], 4, 2))
    out["dist_attr"] = [repr(p) for p in
                        dist.DistAttr(mesh, ["x", None]).placements()]
    P.set_device("cpu")
    P.seed(0)
    lin = P.nn.Linear(4, 6)
    w = lin.weight
    dist.shard_tensor(w, mesh, [R(), S(1)])
    out["param_cut"] = (tuple(lin.weight.shape), lin.weight is w,
                        _npy(lin.weight))
    out["param_unshard"] = _npy(dist.unshard_dtensor(lin.weight))
    return out


def spawned_all_reduce(out_dir):
    """A ``distributed.spawn`` target: joins from the launcher's variables
    alone, all-reduces its rank + 1 and writes what it got."""
    import torch

    from paddle_tpu_torch import distributed as dist

    torch.set_num_threads(1)
    env = dist.init_parallel_env(timeout=COLLECTIVE_TIMEOUT_S)
    t = torch.tensor([float(env.rank + 1)])
    dist.all_reduce(t)
    with open(os.path.join(out_dir, f"rank{env.rank}"), "w") as f:
        f.write(f"{env.world_size} {dist.get_backend()} {float(t)}")
    dist.destroy_process_group()
