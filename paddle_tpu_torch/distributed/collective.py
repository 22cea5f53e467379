"""Collectives on ``torch.distributed`` — the counterpart of
``paddle_tpu/distributed/collective.py``.

The JAX package lowers a collective to a ``jax.lax`` op inside a
``shard_map`` trace over a named mesh axis (its in-trace branch), and
otherwise treats a value as the whole world. In the port every rank is a
process, so each collective is the call that rank makes: it takes the
rank's own value and leaves on it what JAX's in-trace branch leaves on
that device. So ``reduce`` leaves the reduction on every rank (as
``psum``) and ``gather`` the gathered list on every rank (as
``all_gather``). ``src`` and ``dst`` are global ranks, as in Paddle.

A ``Group`` is a ``torch.distributed`` process group over some ranks
(``new_group``; every rank creates every group, in the same order). The
default group is the world. Values may be the port's ``Tensor`` or torch
tensors; in-place collectives write the value's storage, and a new value
comes back in the kind given.

``ReduceOp.AVG`` is a sum over the group divided by its size (gloo has no
average); ``PROD`` is the backends' product (JAX gathers and multiplies).
gloo has no reduce-scatter: there ``reduce_scatter`` all-reduces and keeps
the rank's part. ``shift`` (JAX's ``ppermute`` ring, :396-406) and
``all_to_all_dim`` carry gradients (``torch.autograd.Function``): the
backward of a shift by k is a shift by -k, of an all-to-all the opposite
all-to-all. Send and receive are ``torch.distributed``'s point-to-point
calls. Each public collective records itself while it runs
(``current_comm_task``: the op, a sequence number and its age), which the
launcher's heartbeat publishes.
"""
from __future__ import annotations

import functools
import itertools
import time

import torch
import torch.distributed as dist

from ..tensor import Tensor
from . import env

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "is_available",
           "destroy_process_group", "all_reduce", "all_gather",
           "all_gather_object", "reduce_scatter", "broadcast",
           "broadcast_object_list", "reduce", "scatter",
           "scatter_object_list", "gather", "alltoall", "alltoall_single",
           "send", "recv", "isend", "irecv", "P2POp", "batch_isend_irecv",
           "barrier", "wait", "shift", "all_to_all_dim", "split",
           "current_comm_task"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
              "avg": dist.ReduceOp.SUM}
_GIDS = itertools.count(1)


class Group:
    """A process group over ``ranks`` (global ranks, in group order).
    ``pg`` is the torch process group, None on a rank outside it;
    ``axis_name`` names the mesh axis it spans, where it came from one."""

    def __init__(self, ranks, pg, axis_name=None):
        self.id = next(_GIDS)
        self.ranks = list(ranks)
        self.pg = pg
        self.axis_name = axis_name if axis_name is not None else f"g{self.id}"

    @property
    def nranks(self):
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self):
        """This process's rank in the group, -1 outside it."""
        return self.get_group_rank(env.get_rank())

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self):
        return self.rank >= 0

    @property
    def process_group(self):
        return self.pg

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_DEFAULT: dict = {"group": None}


def _world():
    g = _DEFAULT["group"]
    if g is None:
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "distributed.init_parallel_env() first")
        g = _DEFAULT["group"] = Group(range(dist.get_world_size()),
                                      dist.group.WORLD, axis_name="world")
    return g


def _get_group(group):
    return _world() if group is None else group


def new_group(ranks=None, backend=None, timeout=None, axis_name=None):
    """A group over ``ranks`` (default: the world). Every rank of the world
    must call it, with the same ranks, in the same order."""
    world = env.get_world_size()
    ranks = list(range(world)) if ranks is None else sorted(int(r)
                                                             for r in ranks)
    if any(not 0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} outside a world of {world}")
    kwargs = {"timeout": timeout} if timeout is not None else {}
    pg = dist.new_group(ranks, **kwargs)
    if pg is dist.GroupMember.NON_GROUP_MEMBER:
        pg = None
    return Group(ranks, pg, axis_name=axis_name)


def get_group(gid=0):
    return _world()


def is_available():
    return dist.is_available()


def destroy_process_group(group=None):
    """Tear down ``group``, or the whole process group (then
    ``init_parallel_env`` may be called again)."""
    if group is not None:
        if group.pg is not None:
            dist.destroy_process_group(group.pg)
        return
    _DEFAULT["group"] = None
    from . import mesh

    mesh.set_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()
    env._STATE["device"] = None


# ------------------------------------------------------- comm tracking
# The collective in flight (reference comm_task_manager.cc:66): the
# launcher's heartbeat publishes it beside ``hb/<rank>``, so a rank whose
# heartbeat goes stale is named with the collective it is stuck in.
_COMM_TASK = {"op": None, "seq": 0, "start": 0.0}


class _track_comm:
    def __init__(self, op):
        self.op = op

    def __enter__(self):
        _COMM_TASK["op"] = self.op
        _COMM_TASK["seq"] += 1
        _COMM_TASK["start"] = time.time()
        return self

    def __exit__(self, *exc):
        _COMM_TASK["op"] = None
        return False


def current_comm_task():
    """(op, seq, age in seconds) of the collective in flight, or None."""
    op = _COMM_TASK["op"]
    if op is None:
        return None
    return (op, _COMM_TASK["seq"], time.time() - _COMM_TASK["start"])


def _tracked(fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with _track_comm(fn.__name__):
            return fn(*args, **kwargs)

    return call


# ----------------------------------------------------------------- helpers
def _val(x):
    return x._value if isinstance(x, Tensor) else x


def _like(x, v):
    return Tensor(v) if isinstance(x, Tensor) else v


def _pg(g):
    if g.pg is None:
        raise RuntimeError(f"rank {env.get_rank()} is not in {g}")
    return g.pg


def _global(g, r):
    """A ``src`` / ``dst`` as a global rank: a member's own number, else a
    group rank (JAX's reading, :275)."""
    return r if r in g.ranks else g.ranks[r]


def _all_reduce_(v, op, g, async_op=False):
    with torch.no_grad():
        task = dist.all_reduce(v, op=_TORCH_OPS[op], group=_pg(g),
                               async_op=async_op)
        if op == "avg":
            if task is not None:
                task.wait()
                task = None
            v.div_(g.nranks)
    return task


def _all_reduce_coalesced_(tensors, g):
    """Sum ``tensors`` over ``g`` in place, in their own dtypes: one
    coalesced all-reduce per dtype (no bucket to copy into and out of)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    pg = _pg(g)
    with torch.no_grad():
        for ts in by_dtype.values():
            with dist.distributed_c10d._coalescing_manager(group=pg):
                for t in ts:
                    dist.all_reduce(t, group=pg)


def _gather_list(v, g):
    out = [torch.empty_like(v) for _ in range(g.nranks)]
    with torch.no_grad():
        dist.all_gather(out, v.contiguous(), group=_pg(g))
    return out


def _gather_cat(v, dim, g):
    """Every rank's ``v`` concatenated along ``dim`` in group order."""
    return torch.cat(_gather_list(v, g), dim=dim)


def _reduce_scatter_dim(v, dim, g, op="sum"):
    """The sum over the group of ``v``, cut into nranks parts along
    ``dim``; this rank's part."""
    n = g.nranks
    if v.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {v.shape[dim]} does not split "
                         f"over {n} ranks")
    if env.backend() == "nccl" and op != "avg":
        moved = v.movedim(dim, 0).contiguous()
        out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
        with torch.no_grad():
            dist.reduce_scatter_tensor(out, moved, op=_TORCH_OPS[op],
                                       group=_pg(g))
        return out.movedim(0, dim)
    full = v.detach().clone()
    _all_reduce_(full, op, g)
    return full.chunk(n, dim=dim)[g.rank].contiguous()


def _all_to_all_raw(v, split_dim, concat_dim, g):
    """Cut ``v`` into nranks parts along ``split_dim``, send part j to rank
    j, and concatenate what arrives along ``concat_dim`` in rank order
    (JAX's ``all_to_all(tiled=True)``)."""
    n = g.nranks
    if v.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {v.shape[split_dim]} "
                         f"does not split over {n} ranks")
    send = torch.stack(v.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    with torch.no_grad():
        dist.all_to_all_single(recv, send, group=_pg(g))
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _shift_raw(v, offset, g):
    """Rank r's ``v`` goes to rank (r + offset) mod n."""
    n = g.nranks
    me = g.rank
    v = v.contiguous()
    out = torch.empty_like(v)
    if offset % n == 0:
        return v.clone()
    to, frm = g.ranks[(me + offset) % n], g.ranks[(me - offset) % n]
    with torch.no_grad():
        ops = [dist.P2POp(dist.isend, v, to, group=_pg(g)),
               dist.P2POp(dist.irecv, out, frm, group=_pg(g))]
        for task in dist.batch_isend_irecv(ops):
            task.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, offset, g):
        ctx.offset, ctx.g = offset, g
        return _shift_raw(v, offset, g)

    @staticmethod
    def backward(ctx, grad):
        return _shift_raw(grad, -ctx.offset, ctx.g), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, split_dim, concat_dim, g):
        ctx.dims, ctx.g = (split_dim, concat_dim), g
        return _all_to_all_raw(v, split_dim, concat_dim, g)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all_raw(grad, concat_dim, split_dim, ctx.g), None,
                None, None)


def shift(tensor, offset=1, group=None):
    """Ring shift: rank r's value goes to rank (r + offset) mod n; returns
    what this rank receives, in the kind given. Differentiable."""
    g = _get_group(group)
    return _like(tensor, _Shift.apply(_val(tensor), int(offset), g))


def all_to_all_dim(x, split_dim, concat_dim, group=None):
    """Differentiable tiled all-to-all: ``x`` cut along ``split_dim``, part
    j to rank j, the parts received concatenated along ``concat_dim``."""
    g = _get_group(group)
    return _like(x, _AllToAll.apply(_val(x), split_dim, concat_dim, g))


# ------------------------------------------------------------- collectives
@_tracked
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place: every rank's value becomes the reduction over the group.
    Returns the value (or, with ``sync_op=False``, the task to wait on)."""
    g = _get_group(group)
    task = _all_reduce_(_val(tensor), op, g, async_op=not sync_op)
    return tensor if sync_op or task is None else task


@_tracked
def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every rank's value, in group order, appended to ``tensor_list``
    (returned). ``tensor_list=None``: the values concatenated along
    ``axis`` instead."""
    g = _get_group(group)
    parts = _gather_list(_val(tensor), g)
    if tensor_list is None:
        return _like(tensor, torch.cat(parts, dim=axis))
    tensor_list.extend(_like(tensor, p) for p in parts)
    return tensor_list


@_tracked
def all_gather_object(object_list, obj, group=None):
    g = _get_group(group)
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=_pg(g))
    object_list.extend(out)
    return object_list


@_tracked
def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """``tensor`` becomes part r of the reduction: the sum over ranks of
    ``tensor_list[r]`` (a list of nranks values), or, given one value,
    its r-th slice along dim 0 (JAX's tiled form)."""
    g = _get_group(group)
    if isinstance(tensor_list, (list, tuple)):
        if len(tensor_list) != g.nranks:
            raise ValueError(f"reduce_scatter takes {g.nranks} values, got "
                             f"{len(tensor_list)}")
        stacked = torch.stack([_val(t) for t in tensor_list])
        part = _reduce_scatter_dim(stacked, 0, g, op)[0]
    else:
        part = _reduce_scatter_dim(_val(tensor_list), 0, g, op)
    _assign(tensor, part)
    return tensor


def _assign(tensor, v):
    """Write ``v`` into ``tensor``: in its storage when the shapes agree,
    else rebinding a port Tensor's value."""
    t = _val(tensor)
    if tuple(t.shape) == tuple(v.shape):
        with torch.no_grad():
            t.copy_(v)
    elif isinstance(tensor, Tensor):
        tensor._value = v.to(t.dtype)
    else:
        raise ValueError(f"result of shape {tuple(v.shape)} does not fit "
                         f"{tuple(t.shape)}")


@_tracked
def broadcast(tensor, src=0, group=None, sync_op=True):
    """In place: every rank's value becomes ``src``'s."""
    g = _get_group(group)
    with torch.no_grad():
        task = dist.broadcast(_val(tensor), src=_global(g, src),
                              group=_pg(g), async_op=not sync_op)
    return tensor if sync_op else task


@_tracked
def broadcast_object_list(object_list, src=0, group=None):
    g = _get_group(group)
    dist.broadcast_object_list(object_list, src=_global(g, src),
                               group=_pg(g))
    return object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction, left on every rank (JAX's in-trace ``psum``); ``dst``
    reads it."""
    return all_reduce(tensor, op, group, sync_op)


@_tracked
def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank r's value becomes ``tensor_list[r]`` as ``src`` holds it."""
    g = _get_group(group)
    src_g = _global(g, src)
    t = _val(tensor)
    lst = None
    if env.get_rank() == src_g:
        if not tensor_list or len(tensor_list) != g.nranks:
            raise ValueError(f"scatter: src needs {g.nranks} values")
        lst = [_val(x).to(t.dtype).contiguous() for x in tensor_list]
    with torch.no_grad():
        dist.scatter(t, lst, src=src_g, group=_pg(g))
    return tensor


@_tracked
def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    g = _get_group(group)
    src_g = _global(g, src)
    if env.get_rank() == src_g and (in_object_list is None
                                    or len(in_object_list) != g.nranks):
        raise ValueError(
            f"scatter_object_list: len(in_object_list) must equal the group "
            f"size {g.nranks}")
    out = [None]
    dist.scatter_object_list(
        out, in_object_list if env.get_rank() == src_g else None,
        src=src_g, group=_pg(g))
    out_object_list[:] = out
    return out_object_list


@_tracked
def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's value, in group order, appended to ``gather_list`` on
    every rank (JAX's in-trace ``all_gather``); ``dst`` reads it."""
    g = _get_group(group)
    parts = _gather_list(_val(tensor), g)
    if gather_list is not None:
        gather_list.extend(_like(tensor, p) for p in parts)
    return gather_list


@_tracked
def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """``in_tensor_list[j]`` goes to rank j; ``out_tensor_list`` gets, in
    rank order, what every rank sent here."""
    g = _get_group(group)
    if len(in_tensor_list) != g.nranks:
        raise ValueError(f"alltoall takes {g.nranks} values")
    first = in_tensor_list[0]
    send = torch.stack([_val(t) for t in in_tensor_list]).contiguous()
    recv = torch.empty_like(send)
    with torch.no_grad():
        dist.all_to_all_single(recv, send, group=_pg(g))
    out_tensor_list.extend(_like(first, v) for v in recv.unbind(0))
    return out_tensor_list


@_tracked
def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Rows of ``in_tensor`` (dim 0) in ``in_split_sizes`` parts, part j to
    rank j; ``out_tensor`` gets the parts received, in rank order, sized
    ``out_split_sizes`` (equal parts when None)."""
    g = _get_group(group)
    src = _val(in_tensor).contiguous()
    dst = _val(out_tensor)
    if out_split_sizes is not None and sum(out_split_sizes) != dst.shape[0]:
        if not isinstance(out_tensor, Tensor):
            raise ValueError("out_tensor does not hold out_split_sizes rows")
        dst = src.new_empty((sum(out_split_sizes),) + tuple(src.shape[1:]))
        out_tensor._value = dst
    with torch.no_grad():
        task = dist.all_to_all_single(
            dst, src,
            output_split_sizes=(None if out_split_sizes is None
                                else list(out_split_sizes)),
            input_split_sizes=(None if in_split_sizes is None
                               else list(in_split_sizes)),
            group=_pg(g), async_op=not sync_op)
    return out_tensor if sync_op else task


@_tracked
def send(tensor, dst=0, group=None, sync_op=True):
    g = _get_group(group)
    with torch.no_grad():
        dist.send(_val(tensor).contiguous(), dst=_global(g, dst),
                  group=_pg(g))


@_tracked
def recv(tensor, src=0, group=None, sync_op=True):
    g = _get_group(group)
    with torch.no_grad():
        dist.recv(_val(tensor), src=_global(g, src), group=_pg(g))
    return tensor


def isend(tensor, dst=0, group=None):
    g = _get_group(group)
    return dist.isend(_val(tensor).contiguous(), dst=_global(g, dst),
                      group=_pg(g))


def irecv(tensor, src=0, group=None):
    g = _get_group(group)
    return dist.irecv(_val(tensor), src=_global(g, src), group=_pg(g))


class P2POp:
    """One point-to-point operation of ``batch_isend_irecv``: ``op`` is
    ``isend`` or ``irecv``, ``peer`` a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp takes distributed.isend or irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Issue every operation of the list together; returns their tasks."""
    ops = []
    for op in p2p_op_list:
        g = _get_group(op.group)
        ops.append(dist.P2POp(dist.isend if op.op is isend else dist.irecv,
                              _val(op.tensor), _global(g, op.peer),
                              group=_pg(g)))
    return dist.batch_isend_irecv(ops)


@_tracked
def barrier(group=None):
    g = _get_group(group)
    dist.barrier(group=_pg(g))


def wait(tensor, group=None, use_calc_stream=True):
    v = _val(tensor)
    if v.is_cuda:
        torch.cuda.current_stream(v.device).synchronize()
    return tensor


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Paddle's ``split``: build and apply an mp-sharded embedding, row- or
    column-parallel linear over the model-parallel group (JAX
    ``collective.py:606-637``)."""
    from .fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    )

    v = _val(x)
    kw = dict(device=v.device)
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1], **kw)
    elif operation != "linear":
        raise ValueError(
            f"split supports 'linear' or 'embedding', got {operation!r}")
    elif axis == 0:
        layer = RowParallelLinear(size[0], size[1],
                                  has_bias=bias_attr is not False,
                                  input_is_parallel=False, **kw)
    elif axis == 1:
        layer = ColumnParallelLinear(size[0], size[1],
                                     has_bias=bias_attr is not False,
                                     gather_output=gather_out, **kw)
    else:
        raise ValueError(f"split axis must be 0 or 1, got {axis}")
    layer.reset_parameters()
    return _like(x, layer(v))
