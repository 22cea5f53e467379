"""Pipeline parallelism — the counterpart of
``paddle_tpu/distributed/fleet/pipeline.py`` (the schedules :345-431, the
engine :170-342 and :453-579) and of the pipeline layers and wrappers of
``paddle_tpu/distributed/fleet/meta_parallel.py:172-411`` (Paddle
``pp_layers.py``, ``pipeline_parallel.py:684`` 1F1B, ``:1308`` VPP).

**Layers.** ``PipelineLayer`` holds a list of ``LayerDesc`` /
``SharedLayerDesc`` / layers, cut into ``num_stages * v`` chunks by
``SegmentLayers`` (JAX's uniform cut; v the virtual pipeline degree);
chunk c lives on stage c % p. Under a hybrid group with pp > 1 a rank
builds only its own chunks' layers, and a shared layer only on the stages
that use it; at world size 1 (or without a group) it builds them all and
every chunk runs in this process, as JAX's engine runs every stage on its
one device (``meta_parallel.py:328-329``). Parameters keep JAX's names:
layer i is ``run_function.{i}``, and a shared layer sits under its first
use, ``run_function.{first}.shared``, on every stage that holds a copy.

**Schedules.** ``_1f1b_instructions`` (``warmup_extra`` for Eager1F1B),
``_fthenb_instructions``, ``_zb_h1_instructions``, ``_SCHEDULES`` and
``_normalize_schedule`` are JAX's, as they are ("vpp" is 1F1B streams over
``p * v`` chunks).

**The engine.** JAX's readiness loop (:489-496, :546-559) is run as a
pure simulation over every chunk's stream (``global_order``): one global
order of (chunk, op, micro-batch). Each rank executes its own chunks' ops
in that order; a boundary activation or gradient for a chunk on another
rank travels by ``isend`` (kept until the step ends) and the receiver
posts its ``irecv`` at the producer's place in the same order, so every
pair of ranks posts its messages in one order and a consumer waits only
for an op earlier in the order: no deadlock, VPP's several chunks per
rank included, in JAX's order. At world size 1 the hand-off is local. A
boundary's shape and dtype go once, in a header ahead of its first
tensor, for each micro-batch shape.

* F runs the chunk under ``no_grad`` and keeps only its input (JAX's
  activation contract: per-chunk recompute). B runs the chunk's forward
  again under grad and calls ``torch.autograd.backward`` with the
  chunk's input and parameters as ``inputs``, as JAX's ``_bwd_fn``
  re-traces inside ``jax.vjp``; the gradients accumulate in the
  parameters' ``.grad`` in micro-batch order. The last chunk fuses the
  loss: its F does nothing, its B runs forward, loss and backward with
  the loss scaled by ``loss_scale / m`` (``_last_fn`` :257). ZB-H1's B
  computes the input gradient only, its W the weight gradient later
  (:278-316), each with its own recompute, as JAX's.
* Random draws (dropout): at the start of a step one int64 ``s`` is drawn
  from the device's default generator (``micro_seed``); micro-batch i's
  forward starts from that generator seeded with ``s + i`` and its chunks
  continue the stream in order (the state travels with the boundary
  activation). A recompute replays the state its forward started from.
  So a micro-batch draws what the unpipelined forward of that
  micro-batch draws from the same seed, whatever the cut and the
  schedule, and the recompute's masks are the forward's.
* A shared weight's gradient is summed over the ranks of the stages that
  hold it, through one process group of them, so every copy takes the
  same update (JAX :561-576).

**The wrappers.** ``PipelineParallel.train_batch((x, y), optimizer,
lr_scheduler, scaler)`` cuts this rank's batch into ``accumulate_steps``
micro-batches along dim 0, runs the engine under the strategy's
``schedule_mode``, then: the gradients averaged over the data axes (dp,
and sharding unless a ZeRO stage owns it), the scaler (found-inf a max
over the world), the optimizer step (a ZeRO stage's, when the strategy
sets ``sharding``), ``clear_grad`` and the scheduler. Every rank returns
the mean loss: averaged over the data axes on the last stage and
broadcast from it over the pipe group, as Paddle does (JAX returns it on
the last device). Boundary values are single tensors.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ...framework import default_generator
from ...nn.layer import Layer
from ...tensor import Tensor
from ..collective import _all_reduce_, _all_reduce_coalesced_, _pg, broadcast
from ..layout import set_layout

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "PipelineParallel", "PipelineParallelWithInterleave",
           "PipelineEngine", "global_order", "micro_seed"]


# ------------------------------------------------------------ schedules
def _1f1b_instructions(num_stages: int, num_micro: int, warmup_extra: int = 0):
    """Per-stage 1F1B instruction streams: stage s runs min(p-1-s, m)
    warmup forwards, alternates 1F/1B, then drains; ``warmup_extra=1``
    gives Eager1F1B (one more forward in flight)."""
    streams = []
    for s in range(num_stages):
        warmup = min(num_stages - 1 - s + warmup_extra, num_micro)
        ops = [("F", i) for i in range(warmup)]
        f_i, b_i = warmup, 0
        while f_i < num_micro:
            ops.append(("F", f_i))
            ops.append(("B", b_i))
            f_i += 1
            b_i += 1
        while b_i < num_micro:
            ops.append(("B", b_i))
            b_i += 1
        streams.append(ops)
    return streams


def _fthenb_instructions(num_stages: int, num_micro: int):
    """FThenB: every stage runs all forwards, then all backwards."""
    return [
        [("F", i) for i in range(num_micro)]
        + [("B", i) for i in range(num_micro)]
        for _ in range(num_stages)
    ]


def _zb_h1_instructions(num_stages: int, num_micro: int):
    """ZB-H1 zero-bubble streams: B is the input gradient, W the weight
    gradient; warmup and steady state as 1F1B, W ops fill the cooldown
    and drain at the end."""
    streams = []
    for s in range(num_stages):
        warmup = min(num_stages - 1 - s, num_micro)
        ops = [("F", i) for i in range(warmup)]
        f_i, b_i, w_i = warmup, 0, 0
        while f_i < num_micro:
            ops.append(("F", f_i))
            ops.append(("B", b_i))
            f_i += 1
            b_i += 1
        while b_i < num_micro:
            ops.append(("B", b_i))
            b_i += 1
            ops.append(("W", w_i))
            w_i += 1
        while w_i < num_micro:
            ops.append(("W", w_i))
            w_i += 1
        streams.append(ops)
    return streams


#: schedule name -> (stream generator, uses split B/W backward)
_SCHEDULES = {
    "1F1B": (lambda p, m: _1f1b_instructions(p, m), False),
    "Eager1F1B": (lambda p, m: _1f1b_instructions(p, m, warmup_extra=1),
                  False),
    "FThenB": (_fthenb_instructions, False),
    "ZB-H1": (_zb_h1_instructions, True),
}


def _normalize_schedule(name: str) -> str:
    key = str(name).replace("_", "").replace("-", "").lower()
    for canon in _SCHEDULES:
        if canon.replace("-", "").lower() == key:
            return canon
    if key in ("zbh1", "zerobubble", "zb"):
        return "ZB-H1"
    if key == "vpp":
        # VPP lives in the chunking (p * v chunks, c on stage c % p)
        return "1F1B"
    raise ValueError(
        f"unknown pipeline schedule {name!r}; choose from {list(_SCHEDULES)}")


def global_order(n_chunks, num_micro, schedule):
    """JAX's readiness loop over every chunk's stream, run as a
    simulation: the list of (chunk, op, micro-batch) in the order JAX's
    engine executes them."""
    gen, split = _SCHEDULES[_normalize_schedule(schedule)]
    streams = gen(n_chunks, num_micro)
    acts = [set() for _ in range(n_chunks)]
    grads = [set() for _ in range(n_chunks)]
    acts[0] = set(range(num_micro))
    cursors = [0] * n_chunks
    last = n_chunks - 1
    order = []

    def ready(s, op, mb):
        if op == "F" or s == last:
            return mb in acts[s]
        return mb in grads[s] and mb in acts[s]

    remaining = sum(len(st) for st in streams)
    while remaining:
        progressed = False
        for s in range(last, -1, -1):
            while cursors[s] < len(streams[s]):
                op, mb = streams[s][cursors[s]]
                if not ready(s, op, mb):
                    break
                order.append((s, op, mb))
                if op == "F":
                    if s < last:
                        acts[s + 1].add(mb)
                elif op == "W":
                    acts[s].discard(mb)
                    grads[s].discard(mb)
                else:
                    if s > 0:
                        grads[s - 1].add(mb)
                    if not split:
                        acts[s].discard(mb)
                        grads[s].discard(mb)
                cursors[s] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            raise RuntimeError("pipeline schedule deadlocked (bug)")
    return order


def micro_seed(generator):
    """One int64 drawn from ``generator``: micro-batch i's forward starts
    from the generator seeded with it + i (a step's one draw)."""
    t = torch.empty((), dtype=torch.int64, device=generator.device)
    t.random_(0, 2 ** 62, generator=generator)
    return int(t.item())


# ---------------------------------------------------------------- layers
class LayerDesc:
    """Reference pp_layers.py:57 — a layer built lazily, on the stages
    that hold it."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """Reference pp_layers.py:77 — a layer shared between stages (tied
    embeddings); ``forward_func(layer, x)`` is its use at this place."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Reference pp_layers.py:93 — the uniform (or by layer name) cut of
    the layer list into ``num_parts`` (JAX ``do_segment``)."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.layers_desc = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self):
        n = len(self.layers_desc)
        if self.method == "uniform":
            result = [0]
            for i in range(1, self.num_parts + 1):
                result.append((n * i) // self.num_parts)
            return result
        if self.method.startswith("layer:"):
            layer_name = self.method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self.layers_desc)
                     if getattr(d.layer_func if isinstance(d, LayerDesc)
                                else type(d), "__name__", "") == layer_name]
            result = [0]
            per = len(marks) // self.num_parts
            for i in range(1, self.num_parts):
                result.append(marks[i * per])
            result.append(n)
            return result
        raise ValueError(f"unknown segment method {self.method}")


class _SharedCaller(torch.nn.Module):
    """One use of a shared layer. The layer is registered (``shared``) at
    its first use only, so its parameters have one name per stage."""

    def __init__(self, shared, forward_func, register):
        super().__init__()
        if register:
            self.shared = shared
        else:
            object.__setattr__(self, "_shared", shared)
        self.forward_func = forward_func

    @property
    def layer(self):
        return self._modules.get("shared") or self.__dict__["_shared"]

    def forward(self, *args, **kwargs):
        if self.forward_func is not None:
            return self.forward_func(self.layer, *args, **kwargs)
        return self.layer(*args, **kwargs)


def _unwrap(x):
    return x._value if isinstance(x, Tensor) else x


class _Chunk:
    """One pipeline chunk: a run of the layer list (not a module of its
    own: its layers are the PipelineLayer's)."""

    def __init__(self, callers):
        self.callers = callers
        seen, params = set(), []
        for c in callers:
            mod = c.layer if isinstance(c, _SharedCaller) else c
            for p in torch.nn.Module.parameters(mod):
                if id(p) not in seen and p.requires_grad:
                    seen.add(id(p))
                    params.append(p)
        self.params = params

    def __call__(self, x):
        for layer in self.callers:
            x = _unwrap(layer(x))
        return x


def _hcg():
    from .base import get_hybrid_communicate_group

    return get_hybrid_communicate_group()


def _vpp_of(strategy):
    cfg = getattr(strategy, "hybrid_configs", None) or {}
    pp_cfg = cfg.get("pp_configs", {}) if isinstance(cfg, dict) else {}
    return int(pp_cfg.get("virtual_pp_degree", 1)) if isinstance(
        pp_cfg, dict) else 1


class PipelineLayer(Layer):
    """Reference pp_layers.py:937: the model as a list of layer
    descriptions, cut into stages. ``num_virtual_pipeline_stages`` (else
    the fleet strategy's ``pp_configs["virtual_pp_degree"]``, else 1) is
    the number of chunks per stage."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None, **kwargs):
        super().__init__()
        hcg = _hcg()
        pp = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
        self._num_stages = int(num_stages or (
            topology.get_dim("pp") if topology is not None else pp))
        if pp > 1 and self._num_stages != pp:
            raise ValueError(f"num_stages {self._num_stages} != the hybrid "
                             f"group's pp degree {pp}")
        if num_virtual_pipeline_stages is None:
            from .fleet_api import fleet_obj

            num_virtual_pipeline_stages = _vpp_of(fleet_obj.strategy)
        self._vpp = max(1, int(num_virtual_pipeline_stages))
        self._hcg = hcg if pp > 1 else None
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self.layers_desc = list(layers)
        self.segment_parts = SegmentLayers(self.layers_desc,
                                           self._num_stages,
                                           seg_method).do_segment()
        self._stage_owned = [(self.segment_parts[s],
                              self.segment_parts[s + 1])
                             for s in range(self._num_stages)]
        n_chunks = self._num_stages * self._vpp
        self.chunk_parts = SegmentLayers(self.layers_desc, n_chunks,
                                         "uniform").do_segment()
        stage = self._hcg.get_stage_id() if self._hcg is not None else None
        self._local_chunks = [c for c in range(n_chunks)
                              if stage is None or c % self._num_stages
                              == stage]
        local = [i for c in self._local_chunks
                 for i in range(self.chunk_parts[c], self.chunk_parts[c + 1])]
        # shared key -> (first index, the stages that use it)
        self._shared_info = {}
        for i, d in enumerate(self.layers_desc):
            if isinstance(d, SharedLayerDesc):
                first, stages = self._shared_info.get(d.layer_name,
                                                      (i, set()))
                stages.add(self.stage_of_layer(i))
                self._shared_info[d.layer_name] = (first, stages)
        self._shared_layers = {}
        self.run_function = torch.nn.ModuleDict()
        self._callers = {}
        for i in local:
            d = self.layers_desc[i]
            if isinstance(d, SharedLayerDesc):
                key = d.layer_name
                first_desc = self.layers_desc[self._shared_info[key][0]]
                if key not in self._shared_layers:
                    self._shared_layers[key] = d.build_layer()
                    self.run_function[str(self._shared_info[key][0])] = (
                        _SharedCaller(self._shared_layers[key],
                                      first_desc.forward_func, True))
                canon = self.run_function[str(self._shared_info[key][0])]
                self._callers[i] = (
                    canon if d.forward_func is first_desc.forward_func
                    else _SharedCaller(self._shared_layers[key],
                                       d.forward_func, False))
            else:
                layer = d.build_layer() if isinstance(d, LayerDesc) else d
                self.run_function[str(i)] = layer
                self._callers[i] = layer
        self._local_indices = local
        self._shared_groups = {}
        if self._hcg is not None:
            self._lay_shared()

    # -- placement ------------------------------------------------------
    def stage_of_layer(self, i):
        """The stage that holds layer ``i`` (its chunk's c % p)."""
        for c in range(len(self.chunk_parts) - 1):
            if self.chunk_parts[c] <= i < self.chunk_parts[c + 1]:
                return c % self._num_stages
        raise IndexError(i)

    def _lay_shared(self):
        """The groups of each shared layer's copies (every group made on
        every rank in one order); copies start equal (broadcast from the
        first stage's rank), and a later stage's copy does not count in
        the global norm."""
        from ..collective import new_group

        hcg = self._hcg
        topo = hcg.topology()
        names = topo.get_hybrid_group_names()
        others = [a for a in names if a != "pp"]
        me = hcg.global_rank
        for key in sorted(self._shared_info):
            first, stages = self._shared_info[key]
            stages = sorted(stages)
            if len(stages) < 2:
                continue
            mine = None
            for coord in itertools.product(
                    *[range(topo.get_dim(a)) for a in others]):
                kw = dict(zip(others, coord))
                ranks = [topo.get_rank(pp=s, **kw) for s in stages]
                g = new_group(ranks, axis_name=f"shared_{key}")
                if me in ranks:
                    mine = g
            if mine is None:
                continue
            self._shared_groups[key] = mine
            layer = self._shared_layers[key]
            with torch.no_grad():
                for p in torch.nn.Module.parameters(layer):
                    broadcast(p.data, src=mine.ranks[0], group=mine)
                    if hcg.get_stage_id() != stages[0]:
                        p._pp_shared_copy = True

    def get_num_stages(self):
        return self._num_stages

    def stage_layers(self, stage_id):
        lo, hi = self._stage_owned[stage_id]
        return [self._callers[i] for i in range(lo, hi)
                if i in self._callers]

    def chunks(self, n_chunks=None):
        """{chunk index: _Chunk} of this rank's chunks; at world size 1
        ``n_chunks`` may cut the layers anew (a wrapper's VPP degree)."""
        bounds, local = self.chunk_parts, self._local_chunks
        if n_chunks is not None and n_chunks != len(bounds) - 1:
            if self._hcg is not None:
                raise ValueError(
                    f"{n_chunks} chunks: this rank built its layers for "
                    f"{len(bounds) - 1}; pass num_virtual_pipeline_stages")
            bounds = SegmentLayers(self.layers_desc, n_chunks,
                                   "uniform").do_segment()
            local = range(n_chunks)
        if any(a == b for a, b in zip(bounds, bounds[1:])):
            raise ValueError(f"{len(self.layers_desc)} layers do not fill "
                             f"{len(bounds) - 1} pipeline chunks")
        return {c: _Chunk([self._callers[i]
                           for i in range(bounds[c], bounds[c + 1])])
                for c in local}

    def forward(self, x):
        if self._hcg is not None:
            raise RuntimeError("a PipelineLayer over pp > 1 ranks holds "
                               "only its stage: run it through "
                               "PipelineParallel")
        for i in self._local_indices:
            x = self._callers[i](x)
        return x

    def loss_fn(self, output, label):
        if self._loss_fn is None:
            raise RuntimeError("PipelineLayer built without loss_fn")
        return self._loss_fn(output, label)


# ---------------------------------------------------------------- engine
_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int64, torch.int32]


class PipelineEngine:
    """Runs this rank's chunks of a ``n_chunks`` chain (chunk c on stage
    c % p) in the global order of ``schedule``. ``chunks``: {c: _Chunk}
    of this rank; ``pipe_group``: the pipe group (None: every chunk is
    here)."""

    def __init__(self, chunks, n_chunks, num_stages, loss_fn,
                 schedule="1F1B", pipe_group=None, device=None):
        self.chunks = chunks
        self.n_chunks = n_chunks
        self.num_stages = num_stages
        self.loss_fn = loss_fn
        self.schedule = _normalize_schedule(schedule)
        self.split_bw = _SCHEDULES[self.schedule][1]
        self.group = pipe_group if (pipe_group is not None
                                    and pipe_group.nranks > 1) else None
        self.stage = self.group.rank if self.group is not None else None
        self.device = device
        self._orders = {}
        self._signature = None
        self._shapes = {}          # chunk c -> (shape, dtype) of its input
        self._headed = set()       # chunks whose header this rank sent
        self.sent = 0              # the last window's sends
        self.held_peak = 0         # the most of them held at once

    def owner(self, c):
        return c % self.num_stages

    def mine(self, c):
        return self.stage is None or self.owner(c) == self.stage

    def _peer(self, c):
        return self.group.ranks[self.owner(c)]

    # -- messages -------------------------------------------------------
    def _send(self, c, t, header, sends):
        """Send ``t`` (for chunk c) to chunk c's owner."""
        g, dst = self.group, self._peer(c)
        if header:
            shape = list(t.shape)
            h = torch.tensor([len(shape)] + shape + [0] * (7 - len(shape))
                             + [_DTYPES.index(t.dtype)], dtype=torch.int64,
                             device=t.device)
            sends.append((torch.distributed.isend(h, dst, _pg(g)), h))
        t = t.contiguous()
        sends.append((torch.distributed.isend(t, dst, _pg(g)), t))
        self.sent += 1 + bool(header)

    def _post_recv(self, c, like_shape, like_dtype, src_chunk):
        g, src = self.group, self._peer(src_chunk)
        buf = torch.empty(like_shape, dtype=like_dtype, device=self.device)
        return torch.distributed.irecv(buf, src, _pg(g)), buf

    def _recv_header(self, src_chunk):
        h = torch.empty(9, dtype=torch.int64, device=self.device)
        torch.distributed.recv(h, self._peer(src_chunk), _pg(self.group))
        h = h.tolist()
        return tuple(h[1:1 + h[0]]), _DTYPES[h[8]]

    # -- one window -----------------------------------------------------
    def run(self, micro_inputs, micro_labels, loss_scale=1.0,
            forward_only=False):
        """One accumulation window of ``m`` micro-batches (every rank
        passes them; the first stage reads the inputs, the last the
        labels). Returns the last chunk's losses (unscaled), this rank's
        list (empty off the last stage), or with ``forward_only`` its
        outputs too."""
        m = len(micro_inputs)
        n = self.n_chunks
        sig = (tuple(micro_inputs[0].shape), micro_inputs[0].dtype, m)
        if sig != self._signature:
            self._signature, self._shapes, self._headed = sig, {}, set()
        key = (m, "FThenB" if forward_only else self.schedule)
        if key not in self._orders:
            order = global_order(n, m, key[1])
            if forward_only:
                order = [o for o in order if o[1] == "F"]
            self._orders[key] = order
        order = self._orders[key]
        gen = default_generator(self.device)
        seed = micro_seed(gen)
        after_draw = gen.get_state()
        acts, grads, states = {}, {}, {}      # (c, mb) -> value
        pending = {}                          # (c, kind, mb) -> (work, buf)
        sends = {}                            # mb -> [(work, tensor)]
        losses, outputs = [], []
        inv_m = loss_scale / m
        last = n - 1
        st_shape = tuple(after_draw.shape)

        def take(store, kind, c, mb):
            k = (c, mb)
            if k not in store:
                work, buf = pending.pop((c, kind, mb))
                work.wait()
                store[k] = buf
            return store[k]

        def state_of(c, mb):
            if c == 0:
                g2 = torch.Generator(device=gen.device)
                g2.manual_seed(seed + mb)
                return g2.get_state()
            return take(states, "state", c, mb).cpu()

        self.sent = self.held_peak = 0
        for c, op, mb in order:
            self.held_peak = max(self.held_peak,
                                 sum(map(len, sends.values())))
            produces = (op == "F" and c < last) or (
                op == "B" and c > 0 and not forward_only)
            dst = c + 1 if op == "F" else c - 1
            if not self.mine(c):
                # post this rank's receives at the producer's place
                if produces and self.mine(dst) and self.group is not None:
                    if op == "F":
                        if dst not in self._shapes:
                            self._shapes[dst] = self._recv_header(c)
                        shape, dt = self._shapes[dst]
                        pending[(dst, "act", mb)] = self._post_recv(
                            dst, shape, dt, c)
                        pending[(dst, "state", mb)] = self._post_recv(
                            dst, st_shape, torch.uint8, c)
                    else:
                        shape, dt = self._shapes[c]
                        pending[(dst, "grad", mb)] = self._post_recv(
                            dst, shape, dt, c)
                continue
            chunk = self.chunks[c]
            if op == "F":
                if c == last and not forward_only:
                    continue              # fused into B
                x = (micro_inputs[mb] if c == 0
                     else take(acts, "act", c, mb))
                acts[(c, mb)] = x
                gen.set_state(state_of(c, mb))
                states[(c, mb)] = gen.get_state()
                with torch.no_grad():
                    y = chunk(x)
                    if c == last:
                        outputs.append(y)
                        if micro_labels is not None:
                            losses.append(_unwrap(self.loss_fn(
                                y, micro_labels[mb])).detach())
                        continue
                out_state = gen.get_state()
                if self.mine(dst):
                    acts[(dst, mb)] = y
                    states[(dst, mb)] = out_state
                    self._shapes.setdefault(dst, (tuple(y.shape), y.dtype))
                else:
                    first = dst not in self._headed
                    self._headed.add(dst)
                    self._shapes.setdefault(dst, (tuple(y.shape), y.dtype))
                    self._send(dst, y, first, sends.setdefault(mb, []))
                    self._send(dst, out_state.to(y.device), False,
                               sends[mb])
                if c > 0 and forward_only:
                    acts.pop((c, mb), None)
                continue
            # B or W: this and the earlier micro-batches' sends are waited
            # for and dropped, so a rank holds its sends in flight (in
            # 1F1B its warm-up's), not the window's. Their receivers have
            # read this micro-batch's (its gradient came back through
            # them); any send's receive is posted at its producer's place
            # in the global order, which every rank passes, so no wait
            # blocks for good.
            for k in [k for k in sends if k <= mb]:
                for work, _ in sends.pop(k):
                    work.wait()
            # recompute the chunk's forward from its input
            if self.split_bw and op == "B" and c == 0 and c != last:
                continue            # no input gradient to make: W does all
            x = take(acts, "act", c, mb) if c > 0 else micro_inputs[mb]
            gy = None if c == last else take(grads, "grad", c, mb)
            if c == last and (c, mb) not in states:
                states[(c, mb)] = state_of(c, mb)
            gen.set_state(states[(c, mb)])
            want_x = c > 0 and op != "W"
            xr = x.detach().requires_grad_(want_x) if want_x else x
            with torch.enable_grad():
                y = chunk(xr)
                if c == last:
                    loss = _unwrap(self.loss_fn(y, micro_labels[mb]))
                    target, gt = loss * inv_m, None
                else:
                    target, gt = y, gy
                inputs = ([xr] if want_x else []) + (
                    chunk.params if (op == "W" or not self.split_bw) else [])
                if inputs:
                    torch.autograd.backward(target, gt, inputs=inputs)
            if c == last and op == "B":
                losses.append(loss.detach())
            if want_x:
                dx = xr.grad
                if self.mine(dst):
                    grads[(dst, mb)] = dx
                else:
                    self._send(dst, dx, False, sends.setdefault(mb, []))
            if op == "W" or not self.split_bw:
                acts.pop((c, mb), None)
                grads.pop((c, mb), None)
                states.pop((c, mb), None)
        for held in sends.values():
            for work, _ in held:
                work.wait()
        gen.set_state(after_draw)
        if forward_only:
            return losses, outputs
        return losses


# --------------------------------------------------------------- wrappers
def _base_optimizer(optimizer):
    """(the optimizer whose rule updates, the ZeRO stage over it or None)
    of a fleet / ZeRO wrapper chain."""
    from ..sharding import _ShardOptimizer

    stage, opt = None, optimizer
    while True:
        if isinstance(opt, _ShardOptimizer):
            stage = opt._shard_fn
            opt = opt._inner
        elif hasattr(opt, "_inner_opt") and not hasattr(opt, "_update"):
            opt = opt._inner_opt
        else:
            return opt, stage


class _StageStep:
    """``step()`` of an optimizer under a ZeRO stage (for the scaler)."""

    def __init__(self, optimizer, stage):
        self._opt = optimizer
        self._stage = stage

    def __getattr__(self, name):
        return getattr(self._opt, name)

    def step(self):
        self._stage.step(self._opt)


class PipelineParallel(Layer):
    """Reference pipeline_parallel.py:242: ``train_batch`` / ``eval_batch``
    of a ``PipelineLayer`` through the engine."""

    _virtual_pp_degree = 1

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel requires a PipelineLayer model")
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        cfg = (getattr(strategy, "pipeline_configs", None) or {})
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.micro_batch_size = cfg.get("micro_batch_size", 1)
        self.schedule_mode = cfg.get("schedule_mode", "1F1B")
        vpp = _vpp_of(strategy)
        if vpp > 1:
            self._virtual_pp_degree = vpp
        self._engine = None
        self._zero = None
        self._zero_bound = None
        self._clip_laid = False
        self.syncs = 0

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    # -- construction ---------------------------------------------------
    def _zero_stage_of_strategy(self):
        s = self._strategy
        if s is None or not getattr(s, "sharding", False):
            return None
        k = int((getattr(s, "sharding_configs", None) or {}).get("stage", 0))
        if k == 0:
            return None
        from .. import sharding as zero

        hcg = self._hcg
        axis = ("sharding" if hcg is not None
                and hcg.get_sharding_parallel_world_size() > 1 else "dp")
        mesh = hcg.mesh if hcg is not None else None
        return {1: zero.ShardingStage1, 2: zero.ShardingStage2,
                3: zero.ShardingStage3}[k](axis, mesh)

    def _build_engine(self):
        layers = self._layers
        p = layers.get_num_stages()
        v = max(1, int(self._virtual_pp_degree))
        chunks = layers.chunks(p * v)
        dev = None
        for ch in chunks.values():
            if ch.params:
                dev = ch.params[0].device
                break
        for ch in chunks.values():
            for q in ch.params:
                if getattr(q, "_global_shape", None) is None:
                    set_layout(q, q.shape)
        hcg = layers._hcg
        self._engine = PipelineEngine(
            chunks, p * v, p, layers.loss_fn, schedule=self.schedule_mode,
            pipe_group=hcg.get_pipe_parallel_group() if hcg else None,
            device=dev or torch.device("cpu"))

    def _data_group(self, stage):
        """The group the gradients and the loss average over: the data
        axes (dp, sharding) less the one a ZeRO stage owns."""
        hcg = self._hcg
        if hcg is None:
            return None
        axes = [a for a in ("dp", "sharding")
                if hcg.topology().get_dim(a) > 1
                and (stage is None or a != stage.axis_name)]
        if not axes:
            return None
        if len(axes) == 1:
            return hcg.mesh.get_group(axes[0])
        return hcg.get_fused_group(("dp", "sharding"))

    def _lay_clip(self, base):
        from ...nn.clip import ClipGradByGlobalNorm
        from .hybrid_optimizer import HybridParallelClipGrad

        hcg = self._hcg
        if self._clip_laid or hcg is None:
            return
        self._clip_laid = True
        clip = base._grad_clip
        mp, pp = hcg.get_model_parallel_group(), hcg.get_pipe_parallel_group()
        if isinstance(clip, ClipGradByGlobalNorm):
            base._grad_clip = HybridParallelClipGrad(clip, mp, pp_group=pp)
        elif isinstance(clip, HybridParallelClipGrad):
            # laid by a ZeRO stage (its group) or the hybrid optimizer
            clip.group = clip.group or mp
            clip.pp_group = clip.pp_group or pp

    # -- the step -------------------------------------------------------
    def _split(self, v):
        v = _unwrap(v)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        m = self.accumulate_steps
        if v.shape[0] % m:
            raise ValueError(f"a batch of {v.shape[0]} rows does not split "
                             f"into {m} micro-batches")
        return list(v.to(self._engine.device).chunk(m, dim=0)) if m > 1 \
            else [v.to(self._engine.device)]

    @torch.no_grad()
    def _sync(self, stage):
        """The shared weights' gradients summed over their copies, then
        every gradient averaged over the data group."""
        layers = self._layers
        for key, g in layers._shared_groups.items():
            for q in torch.nn.Module.parameters(layers._shared_layers[key]):
                if not q.requires_grad:
                    continue
                if q.grad is None:      # a use that does not read it
                    q.grad = torch.zeros_like(q)
                _all_reduce_(q.grad, "sum", g)
        g = self._data_group(stage)
        if g is not None:
            grads = [q.grad for ch in self._engine.chunks.values()
                     for q in ch.params if q.grad is not None]
            grads = list({id(t): t for t in grads}.values())
            if grads:
                _all_reduce_coalesced_(grads, g)
                torch._foreach_div_(grads, float(g.nranks))
        self.syncs += 1

    def _mean_loss(self, losses):
        """The mean over micro-batches (JAX's left-to-right sum / m, in
        f32), averaged over the data group, broadcast from the last
        stage."""
        hcg = self._hcg
        dev = self._engine.device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        if losses:
            acc = 0
            for v in losses:
                acc = acc + v.float()
            total = (acc / len(losses)).reshape(())
        if hcg is None:
            return total
        g = self._data_group(None)      # every data axis, ZeRO's too
        if g is not None and hcg.is_last_stage():
            _all_reduce_(total, "avg", g)
        pg = hcg.get_pipe_parallel_group()
        if pg.nranks > 1:
            broadcast(total, src=pg.ranks[-1], group=pg)
        return total

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        if self._engine is None:
            self._build_engine()
            self._zero = self._zero_stage_of_strategy()
        base, stage = _base_optimizer(optimizer)
        if stage is None and self._zero is not None:
            stage = self._zero
            if self._zero_bound is not base:
                stage.bind(base)
                self._zero_bound = base
        if stage is not None and stage.shard_params:
            from ..sharding import install

            install(self._layers)
        self._lay_clip(base)
        x, y = data
        mx, my = self._split(x), self._split(y)
        scaling = scaler is not None and scaler.is_enable()
        loss_scale = float(scaler._scale) if scaling else 1.0
        losses = self._engine.run(mx, my, loss_scale)
        self._sync(stage)
        step = _StageStep(base, stage) if stage is not None else optimizer
        if scaling:
            if self._hcg is not None and self._hcg.nranks > 1:
                scaler._found_inf_group = (
                    self._hcg.get_check_parallel_group())
            scaler.step(step)
        else:
            step.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return Tensor(self._mean_loss(losses))

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        if self._engine is None:
            self._build_engine()
        x, y = data
        mx = self._split(x)
        my = self._split(y) if compute_loss else None
        losses, outs = self._engine.run(mx, my, forward_only=True)
        if compute_loss:
            return Tensor(self._mean_loss(losses))
        return Tensor(torch.cat(outs, 0)) if outs else None

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.set_state_dict(sd, *a, **k)


class PipelineParallelWithInterleave(PipelineParallel):
    """Interleaved virtual pipeline (reference pipeline_parallel.py:1308):
    ``p * virtual_pp_degree`` chunks, chunk c on stage c % p, under the
    1F1B engine."""

    def __init__(self, layers, hcg=None, strategy=None, virtual_pp_degree=2):
        super().__init__(layers, hcg, strategy)
        if self._virtual_pp_degree <= 1:
            self._virtual_pp_degree = virtual_pp_degree
