"""ZeRO — ``ShardingStage1/2/3``, ``shard_optimizer`` and ``shard_scaler``:
the counterpart of ``paddle_tpu/distributed/api.py:165-290`` (Paddle
``dygraph_sharding_optimizer.py:54``, ``group_sharded_stage3.py:85``).

The JAX package gives each stage as layouts of the compiled step (dim 0
of a tensor split over the stage's mesh axis) and lets GSPMD place the
collectives. A rank of the port holds its part and calls them, over its
group along the stage's axis (``axis_name``, "dp" by default, of
``mesh`` or the global mesh), n ranks, this one r:

* which tensors shard: JAX's rule (``_spec`` :215-225), dim 0 split in n
  rows where n divides it, whole otherwise; here also whole where dim 0
  is already split over model parallelism (a row-parallel weight), as
  JAX's pipeline placement keeps it (``pipeline.py:115-118``). At one
  rank the stage keeps its whole machinery (n = 1), so a captured step
  holds the collectives;
* stage 1: each rank keeps its rows of every accumulator; the gradients
  are averaged over the group (all-reduce), each rank updates its rows of
  the parameter, and the rows are all-gathered into the parameter;
* stage 2: the gradients of sharded parameters are reduce-scattered
  (averaged), so a rank holds only its rows (``local_grads``); then as
  stage 1;
* stage 3: the parameters are held as their rows between steps. A module
  that owns one reads it through a property (on a subclass of the
  module's class, as ``torch.nn.utils.parametrize`` does, made once and
  put back by ``uninstall``; ``install`` sets it on a model, as
  ``jit.TrainStep`` and ``PipelineParallel`` do, else a hook finds the
  modules at the first forward and is then removed): each read
  all-gathers the whole
  weight through ``_Gather``, whose backward reduce-scatters (averages)
  the gradient into the rows. Inside ``saving()`` (``jit.TrainStep``'s
  forward) a gathered weight the backward keeps is freed and gathered
  again when the backward needs it (``saved_tensors_hooks``).

The stage owns the gradient sync over its axis: ``parallel.GradientSync``
(``DataParallel``, the hybrid wrappers) leaves alone the gradients of
the parameters a stage averages over its group (``owns``). The update is the optimizer's own rule (``_update``) on the
rows, so it must act element by element: ``Lamb`` (a norm over the whole
parameter) is refused, as is a per-tensor norm clip; a global-norm clip
becomes ``HybridParallelClipGrad`` over the stage's group (the rows'
squared norms summed once). ``shard_scaler`` makes a found-inf on any rank
skip the step on every rank (a max over the world).
"""
from __future__ import annotations

import contextlib
import functools
import weakref

import torch

from . import env
from .collective import _all_reduce_, _all_reduce_coalesced_, _pg
from .layout import cut, layout_of, set_layout
from .mesh import get_mesh

__all__ = ["ShardingStage1", "ShardingStage2", "ShardingStage3",
           "shard_optimizer", "shard_scaler", "owns", "install",
           "uninstall"]

def owns(p, group):
    """Whether a ZeRO stage averages ``p``'s gradient over ``group``'s
    ranks (``parallel.GradientSync`` then leaves it alone)."""
    stage = getattr(p, "_zero_stage", None)
    g = stage.group if stage is not None else None
    return g is not None and tuple(g.ranks) == tuple(group.ranks)


def _reduce_scatter_avg(full, g):
    """This rank's rows of the mean over ``g`` of ``full`` (dim 0)."""
    n = g.nranks
    if env.backend() == "nccl":
        out = full.new_empty((full.shape[0] // n,) + tuple(full.shape[1:]))
        torch.distributed.reduce_scatter_tensor(out, full.contiguous(),
                                                group=_pg(g))
    else:                     # gloo has no reduce-scatter
        red = full.detach().clone()
        _all_reduce_(red, "sum", g)
        out = red.chunk(n, dim=0)[g.rank].clone()
    return out.div_(n)


def _all_gather_rows(part, full, g):
    """Every rank's ``part`` into ``full`` (dim 0, group order)."""
    if env.backend() == "nccl":
        torch.distributed.all_gather_into_tensor(full, part.contiguous(),
                                                 group=_pg(g))
    else:
        outs = list(full.chunk(g.nranks, dim=0))
        bufs = [torch.empty_like(part) for _ in outs]
        torch.distributed.all_gather(bufs, part.contiguous(), group=_pg(g))
        for o, b in zip(outs, bufs):
            o.copy_(b)
    return full


class _Gather(torch.autograd.Function):
    """The whole weight from its rows; the backward reduce-scatters the
    gradient (averaged over the stage's group) into the rows."""

    @staticmethod
    def forward(ctx, part, stage):
        ctx.stage = stage
        return stage._gathered(part)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_avg(grad, ctx.stage.group), None


# ------------------------------------------------ stage 3's properties
# the stage-3 parameters no module reads through a property yet, and the
# modules already looked through
_PENDING = weakref.WeakValueDictionary()   # id -> parameter held as rows
_SEEN = weakref.WeakKeyDictionary()
_HOOK: dict = {"handle": None}
_CLASSES: dict = {}


def _read(module, name):
    p = module._parameters[name]
    stage = getattr(p, "_zero_stage", None)
    if stage is None or not stage.shard_params:
        return module._zero3_base.__getattr__(module, name)
    return stage._use(module, p)


def _sliced(p):
    stage = getattr(p, "_zero_stage", None)
    return stage is not None and stage.shard_params and stage.shards(p)


def _install(module):
    """Give ``module`` properties for its stage-3 parameters: its class
    becomes a subclass of its own class made once per (class, names);
    ``uninstall`` puts the class back."""
    names = tuple(n for n, p in module._parameters.items()
                  if p is not None and _sliced(p))
    for n in names:
        _PENDING.pop(id(module._parameters[n]), None)
    have = getattr(module.__class__, "_zero3_names", ())
    if not names or set(names) <= set(have):
        return
    base = module.__class__._zero3_base if have else module.__class__
    names = tuple(sorted(set(names) | set(have)))
    new = _CLASSES.get((base, names))
    if new is None:
        attrs = {n: property(functools.partial(_read, name=n))
                 for n in names}
        attrs.update(_zero3_names=names, _zero3_base=base)
        new = _CLASSES[(base, names)] = type(base.__name__, (base,), attrs)
    module.__class__ = new


def install(model):
    """Put the stage-3 properties on the modules of ``model`` that own a
    parameter held as rows (``jit.TrainStep`` and ``PipelineParallel``
    call it on their model). Once every such parameter is reached, the
    first-forward hook of ``bind`` is gone."""
    for m in model.modules():
        if m not in _SEEN:
            _install(m)
            _SEEN[m] = True
    if not len(_PENDING) and _HOOK["handle"] is not None:
        _HOOK["handle"].remove()
        _HOOK["handle"] = None


def uninstall(model):
    """Put back the classes ``install`` changed in ``model``."""
    for m in model.modules():
        base = getattr(m.__class__, "_zero3_base", None)
        if base is not None:
            m.__class__ = base
        _SEEN.pop(m, None)


def _first_forward(module, args):
    install(module)


class _Regather:
    """A saved weight dropped after the forward: gathered again from its
    rows when the backward unpacks it."""

    __slots__ = ("param", "size", "stride", "offset")

    def __init__(self, param, t):
        self.param = param
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


# ------------------------------------------------------------ the stages
class ShardingStage1:
    """ZeRO-1: optimizer state sharded along ``axis_name``; parameters and
    gradients whole."""

    stage = 1
    shard_grads = False
    shard_params = False

    def __init__(self, axis_name="dp", mesh=None):
        self.axis_name = axis_name
        self.mesh = mesh
        self._params: list = []
        self.local_grads: dict = {}     # id(param) -> the grad it updates
        self._live = None               # stage 3: gathered in saving()

    # -- layout ---------------------------------------------------------
    def _mesh(self):
        return self.mesh or get_mesh()

    @property
    def group(self):
        m = self._mesh()
        if m is None or self.axis_name not in m.dim_names:
            return None
        return m.get_group(self.axis_name)

    @property
    def nranks(self):
        g = self.group
        return 1 if g is None else g.nranks

    def _spec(self, shape):
        """The number of row blocks dim 0 splits into, or None (whole)."""
        g = self.group
        if g is None or not shape or shape[0] % g.nranks:
            return None
        return g.nranks

    def shards(self, p):
        """Whether parameter ``p`` is held in rows."""
        return getattr(p, "_zero_rows", None) is not None

    def local(self, p):
        """The region of ``p`` this rank updates: its rows (stages 1-2),
        all of it (a whole parameter, stage 3's rows)."""
        rows = getattr(p, "_zero_rows", None)
        if rows is None or self.shard_params:
            return p.detach()
        return p.detach()[rows[0]:rows[1]]

    # -- binding --------------------------------------------------------
    def bind(self, optimizer):
        """Lay the stage over ``optimizer``'s trainable parameters (the
        accumulators are made as rows; stage 3 cuts the parameters)."""
        from ..optimizer import Lamb

        if isinstance(optimizer, Lamb):
            raise NotImplementedError(
                "ZeRO: Lamb's trust ratio is a norm over the whole "
                "parameter; the stage updates rows")
        g = self.group
        if g is None:
            raise ValueError(f"ZeRO over {self.axis_name!r}: the mesh has "
                             f"no such axis")
        n, r = g.nranks, g.rank
        for p in optimizer._params:
            if not p.requires_grad or getattr(p, "_zero_stage", None):
                continue
            p._zero_stage = self
            if (self._spec(tuple(p.shape)) is None
                    or (getattr(p, "is_distributed", False)
                        and getattr(p, "split_axis", None) == 0)):
                continue
            rows = p.shape[0] // n
            p._zero_rows = (r * rows, (r + 1) * rows)
            p._zero_full_shape = tuple(p.shape)
            p._zero_sliced = True
            self._params.append(p)
            if self.shard_params:
                shape, pieces = layout_of(p)
                part_pieces = cut(p, 0, n, r)
                with torch.no_grad():
                    p.data = p.data[r * rows:(r + 1) * rows].clone()
                set_layout(p, shape, part_pieces)
                _PENDING[id(p)] = p
        if self.shard_params:
            _SEEN.clear()               # a module may own new rows
        if len(_PENDING) and _HOOK["handle"] is None:
            # a model the caller runs itself: its modules are found at
            # their first forward (a hook on every module's forward until
            # each parameter held as rows is reached)
            _HOOK["handle"] = (torch.nn.modules.module
                               .register_module_forward_pre_hook(
                                   _first_forward))
        orig = optimizer._acc_init

        def acc_init(name, p, _orig=orig):
            # an accumulator of the region's shape sits where the region
            # does (the checkpoint writes it there)
            t = _orig(name, self.local(p))
            if t.shape == self.local(p).shape:
                if self.shards(p) and not self.shard_params:
                    set_layout(t, layout_of(p)[0], cut(p, 0, n, r))
                else:
                    set_layout(t, *layout_of(p))
            return t

        optimizer._acc_init = acc_init
        clip = optimizer._grad_clip
        from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm
        from .fleet.hybrid_optimizer import HybridParallelClipGrad

        if isinstance(clip, ClipGradByNorm):
            raise NotImplementedError(
                "ZeRO: a per-tensor norm clip needs the whole gradient; "
                "the stage holds rows")
        if isinstance(clip, ClipGradByGlobalNorm):
            optimizer._grad_clip = HybridParallelClipGrad(
                clip, zero_group=g)
        elif isinstance(clip, HybridParallelClipGrad):
            clip.zero_group = g
        return self

    # -- stage 3's gather on use ----------------------------------------
    def _gathered(self, part):
        full = part.new_empty(part._zero_full_shape if hasattr(
            part, "_zero_full_shape") else
            (part.shape[0] * self.nranks,) + tuple(part.shape[1:]))
        return _all_gather_rows(part.detach(), full, self.group)

    def _use(self, module, p):
        full = _Gather.apply(p, self)
        if self._live is not None:
            self._live[full.untyped_storage().data_ptr()] = (
                weakref.ref(full), p)
        from ..nn.layer import Layer

        if isinstance(module, Layer):
            from ..tensor import Tensor

            return Tensor(full, stop_gradient=not p.requires_grad)
        return full

    @contextlib.contextmanager
    def saving(self):
        """Within (the forward of a step whose backward follows): a
        gathered stage-3 weight the backward saves is dropped and gathered
        again from its rows when the backward reads it."""
        if not self.shard_params:
            yield
            return
        live = self._live = {}

        def pack(t):
            hit = live.get(t.untyped_storage().data_ptr())
            if hit is None or hit[0]() is None:
                return t
            return _Regather(hit[1], t)

        def unpack(x):
            if type(x) is not _Regather:
                return x
            with torch.no_grad():
                full = self._gathered(x.param)
            return full.as_strided(x.size, x.stride, x.offset)

        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                yield
        finally:
            self._live = None

    # -- the step -------------------------------------------------------
    @torch.no_grad()
    def reduce_grads(self, params):
        """The gradient each parameter's ``local`` region takes, averaged
        over the group: rows where the parameter shards, whole otherwise.
        A missing gradient is zeros."""
        g = self.group
        n = g.nranks
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        whole = [gr for p, gr in zip(params, grads)
                 if not (self.shards(p) and (self.shard_grads
                                             or self.shard_params))]
        if whole:
            _all_reduce_coalesced_(whole, g)
            torch._foreach_div_(whole, float(n))
        out = []
        self.local_grads = {}
        for p, gr in zip(params, grads):
            if not self.shards(p):
                local = gr
            elif self.shard_params:
                local = gr              # reduce-scattered in the backward
            elif self.shard_grads:
                local = _reduce_scatter_avg(gr, g)
                p.grad = None           # the rank keeps only its rows
            else:
                local = gr[p._zero_rows[0]:p._zero_rows[1]]
            self.local_grads[id(p)] = local
            out.append(local)
        return out

    @torch.no_grad()
    def gather_params(self, params):
        """Stages 1-2: every rank's updated rows into the parameters."""
        if self.shard_params:
            return
        g = self.group
        for p in params:
            if self.shards(p):
                lo, hi = p._zero_rows
                _all_gather_rows(p.detach()[lo:hi].clone(), p.detach(), g)

    @torch.no_grad()
    def apply(self, optimizer, params, grads, lr, step, master=False):
        """One update of every ``local`` region with its gradient (already
        reduced and clipped), then the gather. ``master``: the eager
        ``multi_precision`` path (f32 masters of the regions)."""
        for p, gr in zip(params, grads):
            pv = self.local(p)
            plr = lr * optimizer._lr_scale(p) if not isinstance(
                lr, torch.Tensor) else (lr if optimizer._lr_scale(p) == 1.0
                                        else lr * optimizer._lr_scale(p))
            if (master and p.is_floating_point()
                    and p.dtype != torch.float32):
                m = optimizer._master_weights.get(id(p))
                if m is None:
                    m = pv.float()
                m = optimizer._update(p, m, gr.float(), plr, step)
                optimizer._master_weights[id(p)] = m
                pv.copy_(m.to(p.dtype))
            else:
                pv.copy_(optimizer._update(p, pv, gr.to(p.dtype), plr,
                                           step).to(p.dtype))
        self.gather_params(params)

    def step(self, optimizer):
        """The eager step of ``optimizer`` under the stage: reduce, clip,
        update the regions, gather."""
        params = [p for p in optimizer._params if p.requires_grad]
        grads = self.reduce_grads(params)
        clip = optimizer._grad_clip
        if clip is not None:
            if getattr(clip, "needs_params", False):
                grads = clip.clip_params(params, grads)
            else:
                grads = clip.clip(grads)
        optimizer._step_count += 1
        self.apply(optimizer, params, grads, optimizer.get_lr(),
                   optimizer._step_count,
                   master=optimizer._multi_precision)


class ShardingStage2(ShardingStage1):
    """ZeRO-2: + the gradients reduce-scattered along the stage's axis."""

    stage = 2
    shard_grads = True


class ShardingStage3(ShardingStage1):
    """ZeRO-3: + the parameters held as rows, gathered on use."""

    stage = 3
    shard_grads = True
    shard_params = True


class _ShardOptimizer:
    """An optimizer under a ZeRO stage: ``step`` is the stage's (reduce,
    clip, update the rows, gather); ``jit.TrainStep`` unwraps it and runs
    the same stage inside its captured step."""

    def __init__(self, optimizer, shard_fn=None):
        self._inner = optimizer
        self._shard_fn = shard_fn
        if shard_fn is not None:
            shard_fn.bind(self._inner_opt)

    @property
    def _inner_opt(self):
        return getattr(self._inner, "_inner_opt", self._inner)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def step(self):
        if self._shard_fn is None:
            self._inner.step()
            return
        self._shard_fn.step(self._inner_opt)

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner.state_dict()

    def set_state_dict(self, state):
        return self._inner.set_state_dict(state)


def shard_optimizer(optimizer, shard_fn=None):
    return _ShardOptimizer(optimizer, shard_fn)


def shard_scaler(scaler):
    """Make ``scaler``'s found-inf a max over the world: a non-finite
    gradient on one rank skips the step on every rank (JAX's gradients are
    global, so its ``isfinite`` sees every shard)."""
    from .collective import _world

    scaler._found_inf_group = _world()
    return scaler
