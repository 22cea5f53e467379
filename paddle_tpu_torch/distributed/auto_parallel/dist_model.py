"""``dist.to_static`` -> ``DistModel`` — the counterpart of
``paddle_tpu/distributed/auto_parallel/dist_model.py`` (Paddle
``auto_parallel/api.py:2952`` ``to_static``, ``:2254`` ``DistModel``).

The JAX package compiles one program per step over global arrays. Each
rank of the port runs its part:

* **Without a pipeline**: one captured ``jit.TrainStep`` (``split_label``)
  over the model wrapped in ``parallel.GradientSync`` on the mesh's "dp"
  group (the gradients averaged over it, except those a ZeRO stage
  averages itself). ``__call__`` takes the global batch, as JAX's does,
  and each rank feeds its own "dp" row block (JAX's ``_shard_batch``
  ``device_put``); the loss returned is the mean over "dp" (an all-reduce
  on the device). The ZeRO stage is the one of an optimizer already sharded
  (``parallelize``'s ``dp_config``) or ``Strategy.sharding``'s; AMP is
  ``Strategy.amp`` through ``amp.auto_cast`` (a TrainStep keeps the casts
  of its first call).
* **With a pipeline** (a model ``parallelize`` split over "pp"): the
  ``_pp_chain`` / ``_pp_bounds`` chunks run through ``fleet.pipeline``'s
  engine under ``Strategy.pipeline.schedule_mode`` with
  ``accumulate_steps`` micro-batches of this rank's "dp" rows; VPP re-cuts
  the chain into ``p * vpp`` chunks, chunk c on stage c % p (JAX
  ``:138-153``). A rank holds its stage's chunks (its pp coordinate), so
  the optimizer updates only their parameters: its ZeRO stage averages
  them over "dp" (the stage placement of JAX's ``build_stage_placements``
  follows the ZeRO level), else they are averaged here. The loss is the
  micro-batches' mean on the last stage, averaged over "dp" and broadcast
  over "pp" to every rank.

Eval and predict run the forward without gradients (the pipeline's
forward-only window with one; predict's outputs are broadcast from the
last stage). ``state_dict(mode)`` keeps JAX's keys (``{param}.{acc}`` for
accumulators) and ``set_state_dict`` reads the model's entries, as JAX's;
``dist_main_program`` / ``dist_startup_program`` return None, as JAX's do.
"""
from __future__ import annotations

import contextlib

import torch

from ...nn.layer import Layer
from ...tensor import Tensor
from ..mesh import axis_group, get_mesh
from .strategy import Strategy

__all__ = ["DistModel", "to_static", "LocalLayer"]


def _raw(x):
    return x._value if isinstance(x, Tensor) else x


def _group(mesh, axis):
    """This rank's group along ``axis`` of the model's mesh, or None."""
    return None if mesh is None else axis_group(axis, mesh)


class DistModel:
    """Modes: train (loss and optimizer), eval (loss), predict. A call runs
    one step of the current mode on the global batch."""

    def __init__(self, layer, loader=None, loss=None, optimizer=None,
                 strategy=None, metrics=None):
        self.network = layer
        self._loader = loader
        self._loss = loss
        self._optimizer = optimizer
        self._strategy = strategy or Strategy()
        self._metrics = metrics or []
        self._mesh = getattr(layer, "_pp_mesh", None) or get_mesh()
        self._engine = None
        self._train_step = None

        if loss is not None and optimizer is not None:
            self._mode = "train"
        elif loss is not None:
            self._mode = "eval"
        else:
            self._mode = "predict"

        self._is_pp = getattr(layer, "_pp_chain", None) is not None
        sharding = self._strategy.sharding
        if (sharding.enable and optimizer is not None
                and getattr(optimizer, "_shard_fn", None) is None):
            from ..sharding import (
                ShardingStage1, ShardingStage2, ShardingStage3,
                shard_optimizer,
            )

            stage_cls = {1: ShardingStage1, 2: ShardingStage2,
                         3: ShardingStage3}[int(sharding.stage)]
            self._optimizer = shard_optimizer(optimizer,
                                              stage_cls("dp", self._mesh))
        if self._optimizer is not None:
            self._lay_clip()

    # ------------------------------------------------------------- mode API
    def train(self):
        if self._loss is None or self._optimizer is None:
            raise RuntimeError(
                "DistModel needs both loss and optimizer for train mode")
        self._mode = "train"
        self.network.train()
        return self

    def eval(self):
        if self._loss is None:
            raise RuntimeError("DistModel needs a loss for eval mode")
        self._mode = "eval"
        self.network.eval()
        return self

    def predict(self):
        self._mode = "predict"
        self.network.eval()
        return self

    # ------------------------------------------------------------- pieces
    def _base(self):
        from ..fleet.pipeline import _base_optimizer

        return _base_optimizer(self._optimizer)

    def _lay_clip(self):
        """A global-norm clip sums over "mp" and "pp" too (the ZeRO stage
        laid its own group)."""
        from ...nn.clip import ClipGradByGlobalNorm
        from ..fleet.hybrid_optimizer import HybridParallelClipGrad

        base, _ = self._base()
        clip = base._grad_clip
        mp, pp = _group(self._mesh, "mp"), _group(self._mesh, "pp")
        if isinstance(clip, HybridParallelClipGrad):
            clip.group, clip.pp_group = mp, pp
        elif isinstance(clip, ClipGradByGlobalNorm) and (mp or pp):
            base._grad_clip = HybridParallelClipGrad(clip, mp, pp_group=pp)

    def _amp_ctx(self):
        amp = self._strategy.amp
        if not amp.enable:
            return contextlib.nullcontext()
        from ... import amp as amp_mod

        return amp_mod.auto_cast(
            enable=True, level=amp.level.upper(), dtype=amp.dtype,
            custom_black_list=list(amp.custom_black_list) or None,
            custom_white_list=list(amp.custom_white_list) or None)

    def _rows(self, args):
        """This rank's "dp" row block of each batch argument (dim 0)."""
        g = _group(self._mesh, "dp")
        if g is None:
            return args
        out = []
        for a in args:
            v = _raw(a)
            if isinstance(v, torch.Tensor) and v.dim() >= 1 \
                    and v.shape[0] % g.nranks == 0:
                part = v.chunk(g.nranks, dim=0)[g.rank]
                a = Tensor(part) if isinstance(a, Tensor) else part
            out.append(a)
        return tuple(out)

    def _dp_mean(self, loss):
        g = _group(self._mesh, "dp")
        if g is None:
            return loss
        from ..collective import _all_reduce_

        loss = loss.clone()
        _all_reduce_(loss, "avg", g)
        return loss

    def _ensure_train_step(self):
        if self._train_step is None:
            from ...jit.train import TrainStep
            from ..parallel import GradientSync

            g = _group(self._mesh, "dp")
            net = self.network if g is None else GradientSync(
                self.network, g)
            self._train_step = TrainStep(net, self._loss, self._optimizer,
                                         split_label=True)
        return self._train_step

    # ------------------------------------------------------------ pipeline
    def _ensure_engine(self):
        if self._engine is None:
            from ..fleet.pipeline import PipelineEngine, _Chunk

            chain = self.network._pp_chain
            bounds = self.network._pp_bounds
            vpp = max(1, int(self._strategy.pipeline.vpp_degree))
            p = len(bounds) - 1
            if vpp > 1:
                # the chain re-cut into p*vpp chunks, round-robin placement
                n = len(chain)
                bounds = [(n * i) // (p * vpp) for i in range(p * vpp + 1)]
            n_chunks = len(bounds) - 1
            pg = _group(self._mesh, "pp")
            me = pg.rank if pg is not None else None
            chunks = {c: _Chunk([layer for _, layer in
                                 chain[bounds[c]:bounds[c + 1]]])
                      for c in range(n_chunks) if me is None or c % p == me}
            params = [q for ch in chunks.values() for q in ch.params]
            dev = params[0].device if params else torch.device("cpu")
            self._engine = PipelineEngine(
                chunks, n_chunks, p, self._loss,
                schedule=self._strategy.pipeline.schedule_mode,
                pipe_group=pg, device=dev)
            # this rank updates its stage's parameters only
            base, stage = self._base()
            mine = {id(q) for q in params}
            base._params = [q for q in base._params if id(q) in mine]
            if stage is not None and stage.shard_params:
                from ..sharding import install

                install(self.network)
        return self._engine

    def _micro(self, v):
        m = max(1, int(self._strategy.pipeline.accumulate_steps))
        v = _raw(v).to(self._engine.device)
        return list(v.chunk(m, dim=0)) if m > 1 else [v]

    def _pp_loss(self, losses):
        """The micro-batches' mean (f32) on the last stage, averaged over
        "dp", broadcast over "pp"."""
        from ..collective import broadcast

        total = torch.zeros((), dtype=torch.float32,
                            device=self._engine.device)
        if losses:
            acc = 0
            for v in losses:
                acc = acc + v.float()
            total = (acc / len(losses)).reshape(())
        pg = _group(self._mesh, "pp")
        if pg is None or pg.rank == pg.nranks - 1:
            total = self._dp_mean(total)
        if pg is not None:
            broadcast(total, src=pg.ranks[-1], group=pg)
        return total

    @torch.no_grad()
    def _pp_sync(self):
        """Without a ZeRO stage the stage's gradients are averaged over
        "dp" here."""
        from ..collective import _all_reduce_coalesced_

        _, stage = self._base()
        g = _group(self._mesh, "dp")
        if stage is not None or g is None:
            return
        grads = [q.grad for ch in self._engine.chunks.values()
                 for q in ch.params if q.grad is not None]
        grads = list({id(t): t for t in grads}.values())
        if grads:
            _all_reduce_coalesced_(grads, g)
            torch._foreach_div_(grads, float(g.nranks))

    def _pp_step(self, x, label):
        if isinstance(x, (list, tuple)):
            raise NotImplementedError(
                "pipeline DistModel micro-batches a single input tensor; "
                "multi-input pipeline models are not supported yet")
        engine = self._ensure_engine()
        x, label = self._rows((x, label))
        losses = engine.run(self._micro(x), self._micro(label), 1.0)
        self._pp_sync()
        self._optimizer.step()
        self._optimizer.clear_grad()
        return Tensor(self._pp_loss(losses))

    @torch.no_grad()
    def _pp_forward(self, x, label):
        engine = self._ensure_engine()
        if label is not None:       # eval: this rank's rows, averaged
            x, label = self._rows((x, label))
        my = self._micro(label) if label is not None else None
        losses, outs = engine.run(self._micro(x), my, forward_only=True)
        if label is not None:
            return Tensor(self._pp_loss(losses))
        return Tensor(self._pp_outputs(outs))

    def _pp_outputs(self, outs):
        """The last stage's outputs (the whole batch) on every rank of the
        pipe group."""
        from ..collective import broadcast

        pg = _group(self._mesh, "pp")
        if pg is None:
            return torch.cat(outs, 0)
        dev = self._engine.device
        last = pg.rank == pg.nranks - 1
        y = torch.cat(outs, 0) if last else None
        head = torch.zeros(9, dtype=torch.int64, device=dev)
        if last:
            head[0] = y.dim()
            head[1:1 + y.dim()] = torch.tensor(list(y.shape))
        broadcast(head, src=pg.ranks[-1], group=pg)
        shape = head[1:1 + int(head[0])].tolist()
        if not last:
            y = torch.empty(shape, dtype=torch.float32, device=dev)
        else:
            y = y.float().contiguous()
        broadcast(y, src=pg.ranks[-1], group=pg)
        return y

    # ------------------------------------------------------------ execution
    def __call__(self, *args):
        if self._mode == "train":
            with self._amp_ctx():
                if self._is_pp:
                    *xs, label = args
                    return self._pp_step(xs[0] if len(xs) == 1 else xs,
                                         label)
                step = self._ensure_train_step()
                loss = step(*self._rows(args))
                return Tensor(self._dp_mean(_raw(loss)))
        if self._mode == "eval":
            *xs, label = args
            with torch.no_grad(), self._amp_ctx():
                if self._is_pp:
                    return self._pp_forward(xs[0], label)
                *xs, label = self._rows((*xs, label))
                out = self.network(*xs)
                return Tensor(self._dp_mean(_raw(self._loss(out, label))))
        with torch.no_grad(), self._amp_ctx():
            if self._is_pp:
                return self._pp_forward(args[0], None)
            return self.network(*args)

    # ------------------------------------------------------------- state API
    def _named_state(self):
        if isinstance(self.network, Layer):
            return dict(self.network.state_dict())
        return dict(self.network.state_dict(keep_vars=True))

    def state_dict(self, mode="all"):
        """``mode``: "all" (parameters, buffers and the optimizer's
        accumulators), "model", or "opt"; keys as JAX's."""
        model_sd = self._named_state()
        opt_sd = {}
        if mode in ("all", "opt") and self._optimizer is not None:
            base, _ = self._base()
            names = {id(_raw(t)): k for k, t in model_sd.items()}
            for acc_name, store in base._accumulators.items():
                for pid, v in store.items():
                    pname = names.get(pid)
                    if pname is not None:
                        opt_sd[f"{pname}.{acc_name}"] = Tensor(v)
        if mode == "opt":
            return opt_sd
        if mode == "model":
            return model_sd
        model_sd.update(opt_sd)
        return model_sd

    def set_state_dict(self, state_dict):
        """The model's entries of ``state_dict`` into the network, as
        JAX's (the accumulators' keys are not read)."""
        if isinstance(self.network, Layer):
            self.network.set_state_dict(state_dict)
        else:
            own = set(self._named_state())
            self.network.load_state_dict(
                {k: _raw(v) for k, v in state_dict.items() if k in own},
                strict=False)

    def dist_main_program(self, mode=None):
        """No program object exists (a captured graph holds no program
        text); kept for the reference's API shape."""
        return None

    def dist_startup_program(self, mode=None):
        return None


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None,
              metrics=None):
    """The ``DistModel`` of a (possibly ``parallelize``-d) model
    (reference api.py:2952)."""
    return DistModel(layer, loader, loss, optimizer, strategy, metrics)


class LocalLayer(Layer):
    """Reference auto_parallel/local_layer.py:27: a layer whose forward runs
    on this rank's parts; each output i is wrapped as a ``DistTensor`` of
    ``out_dist_attrs[i]`` = (mesh, placements) (``dtensor_from_local``:
    no data moves)."""

    def __init__(self, out_dist_attrs=None):
        super().__init__()
        self.out_dist_attrs = list(out_dist_attrs or [])

    def __call__(self, *args, **kwargs):
        out = super().__call__(*args, **kwargs)
        if not self.out_dist_attrs:
            return out
        from ..api import dtensor_from_local

        single = not isinstance(out, (tuple, list))
        outs = [out] if single else list(out)
        for i, t in enumerate(outs):
            if i < len(self.out_dist_attrs) and isinstance(
                    t, (Tensor, torch.Tensor)):
                mesh, placements = self.out_dist_attrs[i]
                outs[i] = dtensor_from_local(t, mesh, placements)
        return outs[0] if single else type(out)(outs)
