"""TrainStep — the counterpart of ``paddle_tpu/jit/train.py``.

The JAX package compiles forward, backward, clipping and the optimizer
update into one XLA program per argument signature (``TrainStep._build``
:100-251) and runs it for every later call. The port captures the same
sequence into one CUDA graph per key and replays it:

* a key is the batch's fingerprint (structure, shapes, dtypes:
  ``jit.fingerprint``), the ``split_label`` and ``return_outputs`` flags,
  and the addresses of the parameters and accumulators the step reads and
  writes (a parameter or accumulator replaced by another tensor drops the
  captured steps);
* a key's batch, the step counter (int32) and the learning rate (f32) live
  in one static input buffer (``jit.graphs.StaticBuffers``) filled before
  each run, so every replay reads its own batch, counter and rate; Python
  numbers in the batch go there as 0-d tensors, so a changed number is a
  new value, not a new key (JAX traces them the same way);
* the step: the forward, ``loss.backward()``, the optimizer's clip
  (``_functional_clip`` :29-45: global norm, per-tensor norm or value) and
  the optimizer's rule applied to every trainable parameter IN ITS OWN
  DTYPE (:201-212), written into the parameter, with the accumulators
  written in place (``Optimizer._set_acc``) and created before the first
  run. So under O2 the parameters, the moments and the update are bf16 even
  when the optimizer was built with ``multi_precision``: the JAX TrainStep
  keeps no master weights (the eager ``Optimizer.step`` does).
* Random ops in the step (dropout) draw from the port's default
  generator of the step's device (``framework.default_generator``),
  registered with every capture, so each replay draws new masks, as JAX
  folds a new key into every compiled step (:136, :299, :519). Its state
  is part of ``export_state``: a restored step draws the same masks again.
  The AMP state (``amp.auto_cast``) is not part of the key, as in JAX
  (ROADMAP C): a key's program runs under the AMP state of its first call
  (JAX traces it then) on the CPU and on the card alike, so a step
  captured under ``auto_cast`` keeps its casts.
* ``LBFGS`` is refused: it evaluates a closure and decides on the host.
* On CUDA a key's first call runs the step eagerly on the side stream
  (that call's result) and captures it (``jit.graphs``); later calls
  replay the graph. The capture runs under ``capture_error_mode="global"``
  (``_CAPTURE_MODE``): ``backward()`` launches from autograd's device
  thread, and in this mode an unsafe call from any thread during the
  capture fails it. Nothing in the step may wait on the host (``.item()``,
  ``.cpu()``, ``nonzero``): the capture raises ``jit.graphs.CaptureError``
  and the step does not fall back to eager (``hapi.Model`` does, on the
  same device, and warns). ``captures`` / ``replays`` count the graphs
  captured and the replays run. A call that raises before its capture is
  made is undone: the state it held (parameters, accumulators, counters,
  RNG, scheduler) is copied to the host before the first run and restored,
  so, as in JAX, a failed compile changes nothing.
* On the CPU, which the caller asks for explicitly (the tests do), the
  same step runs every call on the same buffers, without capture.
* A paddle-style model (``nn.Layer``) takes and returns the port's
  ``Tensor``: the batch may hold Tensors (unwrapped into the buffers), the
  step hands the model and the loss function Tensors over the buffers'
  views and unwraps the loss and outputs. Parameters are keyed by their
  torch storage either way; a parameter's ``optimize_attr`` learning rate
  scales its update and its ``regularizer`` replaces ``weight_decay``, as
  in JAX's step (:201-212). Batch norm's running statistics are buffers
  written in place by the forward, so a replay updates them as a body
  does.

``run_steps`` (JAX :254-360) replays one key's graph n times from one
host fill of the n counters and rates, with device-to-device batch
slices; ``aot_prime`` (:531-537) captures ahead and counts one step's
FLOPs; ``export_state`` / ``import_state`` (:401-502) copy the state out
and back into the tensors a graph holds, so a restored step replays.
A bound ``observability.StepMonitor`` (``_monitor``) is called at JAX's
three points: ``step_begin`` on entry, ``before_launch`` once the batch's
program is known (``before_scan_launch`` in ``run_steps``, fingerprint
``("scan", n_steps, flags, avals)``) and ``step_end`` with the returned
loss; its counters ride in ``export_state``'s meta (``"monitor"``) and,
restored before a monitor binds, wait in ``_pending_monitor_counters``.
With none bound a call pays attribute checks only and the captured
program is the same. A sublayer's ``l_aux`` set during the forward (MoE's
balance loss) is added to the loss, as in JAX. ``LookAhead``,
``ModelAverage`` and an ASP-decorated optimizer are refused: their work is
outside ``_update`` (JAX's step raises for the first two and drops the
masks of the third, ROADMAP C). A ZeRO stage
(``distributed.shard_optimizer``, JAX :86-95, :178-185, :226-247) runs in
the step: the forward under the stage's ``saving()``, the gradients
reduced by the stage (rows where it shards) before the clip, the update
on each parameter's rows, the rows gathered after it; on the card its
NCCL reduce-scatters and all-gathers are captured with the step; the
accumulators are rows, and ``export_state`` / ``import_state`` carry them
as they are (stage 3's parameters too). ``lowered`` /
``lowered_steps`` have no counterpart (a CUDA graph has no program text).
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Callable

import numpy as np
import torch

from .. import amp
from ..framework import default_generator
from ..nn.clip import ClipGradBase
from ..nn.layer import Layer
from ..optimizer import LBFGS
from ..optimizer.lr import LRScheduler
from ..tensor import Tensor
from .fingerprint import aval_fingerprint, flatten, unflatten
from .graphs import StaticBuffers, first_run_then_capture

__all__ = ["TrainStep", "StepProgram"]

# backward() launches from autograd's device thread: "global" makes an
# unsafe call from any thread fail the capture
_CAPTURE_MODE = "global"


def _leaf_spec(x):
    """(shape, dtype) of a batch leaf's slot in the input buffer."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if isinstance(x, (np.ndarray, np.generic)):
        return tuple(x.shape), torch.from_numpy(np.empty(0, x.dtype)).dtype
    if isinstance(x, bool):
        return (), torch.bool
    if isinstance(x, int):
        return (), torch.int64
    if isinstance(x, float):
        return (), torch.float64
    raise TypeError(f"TrainStep: a batch holds tensors, arrays and numbers, "
                    f"not {type(x).__name__}")


def _map_tensors(fn, tree):
    leaves, structure = flatten(tree)
    return unflatten(structure, [fn(x) if isinstance(x, torch.Tensor) else x
                                 for x in leaves])


def _unwrapped(tree):
    """``tree`` with the port's Tensors replaced by their torch tensors."""
    leaves, structure = flatten(tree)
    return unflatten(structure, [x._value if isinstance(x, Tensor) else x
                                 for x in leaves])


def _as_tensor(v):
    """A checkpoint value as a tensor; numpy arrays are copied (bf16 ones
    to f32, which holds them exactly)."""
    if isinstance(v, np.ndarray):
        bf16 = v.dtype.name == "bfloat16"
        return torch.from_numpy(np.array(v, np.float32 if bf16 else v.dtype))
    return torch.as_tensor(v)


class StepProgram:
    """One key's step: the input buffer (batch leaves ``a0``, ``a1``, ...,
    then ``step`` and ``lr``), the batch's structure, and on CUDA its
    ``capture`` (``jit.graphs.Capture``). ``flops``: one step's FLOPs once
    ``aot_prime`` counted them (aten products through
    ``torch.utils.flop_counter.FlopCounterMode``; the hand-written
    attention kernels are not counted)."""

    def __init__(self, leaves, structure, device):
        spec = {f"a{i}": _leaf_spec(x) for i, x in enumerate(leaves)}
        spec["step"] = ((), torch.int32)
        spec["lr"] = ((), torch.float32)
        self.inputs = StaticBuffers(spec, device)
        self.structure = structure
        self.n_leaves = len(leaves)
        self.capture = None
        self.flops = None
        self.memory = None
        self.amp_state = amp._snapshot()    # the first call's AMP state

    def batch(self):
        """(args, kwargs) over the buffer's device views."""
        dev = self.inputs.dev
        return unflatten(self.structure,
                         [dev[f"a{i}"] for i in range(self.n_leaves)])


class TrainStep:
    """loss = step(*batch): one training step of ``model`` under
    ``optimizer``.

    Batch convention (:118-130): with ``split_label`` the last positional
    argument is the label; otherwise, when the model's forward can bind
    every argument it gets them all (``GPTForCausalLM(ids, labels=...)``,
    whose output goes to ``loss_fn(*outputs)``), else the last positional
    argument is the label and goes to ``loss_fn(outputs, label)``.
    ``return_outputs``: the call returns (loss, forward outputs).
    ``donate_state`` is accepted: parameters and accumulators are always
    updated in place here."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 donate_state=True, return_outputs=False, split_label=False):
        from ..distributed.fleet.hybrid_optimizer import (
            HybridParallelOptimizer,
        )

        from ..distributed.sharding import _ShardOptimizer, install

        if isinstance(optimizer, HybridParallelOptimizer):
            # fleet's optimizer: the model wrapper's backward syncs the
            # gradients; the update and the hybrid clip are the inner one's
            optimizer = optimizer._inner_opt
        # a ZeRO stage (distributed.shard_optimizer) runs inside the step:
        # its reduce-scatters and all-gathers are captured with it
        self._stage = None
        if isinstance(optimizer, _ShardOptimizer):
            self._stage = optimizer._shard_fn
            optimizer = optimizer._inner_opt
            if self._stage is not None and self._stage.shard_params:
                install(model)
        if isinstance(optimizer, LBFGS):
            raise NotImplementedError(
                "TrainStep(LBFGS): LBFGS evaluates a closure and decides on "
                "the host between evaluations, so it is not one captured "
                "step; call LBFGS.step(closure) eagerly")
        wrapper = getattr(optimizer, "_step_wrapper_name", None)
        if wrapper is not None:
            raise NotImplementedError(
                f"TrainStep({wrapper}): the wrapper's work (slow-weight "
                f"sync, the running average, the sparsity masks) happens in "
                f"its eager step() outside the update rule, which a "
                f"captured step does not run; call {wrapper}.step() "
                f"eagerly")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._return_outputs = return_outputs
        self._split_label = split_label
        # a parallel wrapper (DataParallel, TensorParallel) passes its
        # arguments on: the batch convention is its model's
        self._inner = (model._layers if hasattr(model, "_paddle_io")
                       else model)
        try:
            self._fwd_sig = inspect.signature(type(self._inner).forward)
        except (TypeError, ValueError):
            self._fwd_sig = None
        self._paddle = isinstance(self._inner, Layer)
        self._trainable = {
            k: p for k, p in torch.nn.Module.named_parameters(model)
            if p.requires_grad and p.is_floating_point()}
        self._params = list(self._trainable.values())
        # sublayers that leave an auxiliary loss (MoE's l_aux) per forward
        self._aux_layers = [m for m in model.modules()
                            if "l_aux" in m.__dict__]
        if not self._params:
            raise ValueError("TrainStep: the model has no trainable "
                             "floating-point parameters")
        self.device = self._params[0].device
        self._seed = 0
        self._programs: dict = {}       # key -> StepProgram
        self._state_key = None
        self._pool = None
        self._bodies_only = False
        self.captures = 0               # graphs captured, replays launched
        self.replays = 0
        self._compiled = None           # the aot_prime'd StepProgram
        self._compiled_avals = None     # its batch fingerprint
        self._monitor = None            # observability.StepMonitor.bind()
        self._pending_monitor_counters = None   # restored before a bind

    # ------------------------------------------------------------ the step
    def _split(self, args, kwargs):
        if self._split_label:
            return args[:-1], args[-1]
        if self._fwd_sig is not None:
            try:
                self._fwd_sig.bind(self._inner, *args, **kwargs)
            except TypeError:
                return args[:-1], args[-1]
        return args, None

    def _clip(self, grads):
        clip = self.optimizer._grad_clip
        if clip is None:
            return grads
        if not isinstance(clip, ClipGradBase):
            raise NotImplementedError(
                f"TrainStep clips by global norm, norm or value, got "
                f"{type(clip)}")
        if getattr(clip, "needs_params", False):
            # the hybrid clip tells sharded parameters from replicated ones
            return clip.clip_params(self._params, grads)
        return clip.clip(grads)

    def _step(self, args, kwargs, lr, step):
        """(loss, forward outputs or None) of one step over ``args`` /
        ``kwargs``; the parameters and accumulators are updated in place."""
        opt = self.optimizer
        model_args, label = self._split(args, kwargs)
        for p in self._params:
            p.grad = None
        if self._paddle:
            model_args, kwargs, label = _map_tensors(
                Tensor, (model_args, kwargs, label))
        before = [m.l_aux for m in self._aux_layers]
        stage = self._stage
        with (stage.saving() if stage is not None
              else contextlib.nullcontext()):
            out = self.model(*model_args, **kwargs)
            if label is not None:
                loss = self.loss_fn(out, label)
            elif isinstance(out, (tuple, list)):
                loss = self.loss_fn(*out)
            else:
                loss = self.loss_fn(out)
        loss, out = _unwrapped((loss, out))
        for m, old in zip(self._aux_layers, before):
            # an auxiliary loss this forward set joins the objective, as
            # JAX :153-159 adds a sublayer's fresh l_aux
            aux = m.l_aux
            if aux is not None and aux is not old:
                loss = loss + _unwrapped(aux).to(loss.dtype)
        loss.backward()
        if stage is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self._params]
        else:       # averaged over the stage's group: rows where it shards
            grads = stage.reduce_grads(self._params)
        grads = self._clip(grads)
        with torch.no_grad():
            for p, g in zip(self._params, grads):
                p.grad = None
                scale = opt._lr_scale(p)
                plr = lr if scale == 1.0 else lr * scale
                pv = p.detach() if stage is None else stage.local(p)
                pv.copy_(opt._update(p, pv, g.to(p.dtype), plr, step))
            if stage is not None:
                stage.gather_params(self._params)
        outs = (_map_tensors(torch.Tensor.detach, out)
                if self._return_outputs else None)
        return loss.detach(), outs

    def _body(self, prog, count_flops=False):
        args, kwargs = prog.batch()
        inp = prog.inputs.dev
        with amp._restored(prog.amp_state):
            if not count_flops:
                return self._step(args, kwargs, inp["lr"], inp["step"])
            from torch.utils.flop_counter import FlopCounterMode

            with FlopCounterMode(display=False) as counter:
                result = self._step(args, kwargs, inp["lr"], inp["step"])
        prog.flops = float(counter.get_total_flops())
        return result

    # ------------------------------------------------------ keys, programs
    def _state_tensors(self):
        accs = self.optimizer._accumulators
        return self._params + [store[id(p)] for store in accs.values()
                               for p in self._params if id(p) in store]

    def _program(self, args, kwargs):
        """The StepProgram of this batch's key, made on first use (the
        accumulators the update reads exist before the key is taken)."""
        self.optimizer._materialize_accumulators(self._params)
        state = tuple(t.data_ptr() for t in self._state_tensors())
        if state != self._state_key:        # graphs of the old tensors go
            self._programs.clear()
            self._state_key = state
        key = (aval_fingerprint(args, kwargs), self._split_label,
               self._return_outputs, state)
        prog = self._programs.get(key)
        if prog is None:
            leaves, structure = flatten((tuple(args), dict(kwargs)))
            prog = self._programs[key] = StepProgram(leaves, structure,
                                                     self.device)
        return prog

    def _fill(self, prog, args, kwargs, **scalars):
        leaves, _ = flatten((tuple(args), dict(kwargs)))
        values = {f"a{i}": x for i, x in enumerate(leaves)}
        values.update(scalars)
        prog.inputs.fill(values)

    def _run(self, prog, count_flops=False):
        """(result, replayed): one step on the program's buffers — its body,
        or on CUDA its first run and capture, or a replay (whose result is
        the capture's own tensors, rewritten by the next replay)."""
        if self.device.type != "cuda" or self._bodies_only:
            return self._body(prog, count_flops), False
        if prog.capture is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            out, prog.capture = first_run_then_capture(
                self.device, lambda: self._body(prog, count_flops),
                lambda: self._body(prog), self._pool, _CAPTURE_MODE,
                generators=(default_generator(self.device),))
            self.captures += 1
            self._note_memory(prog)
            return out, False
        if count_flops:
            return self._body(prog, True), False
        prog.capture.replay()
        self.replays += 1
        return prog.capture.result, True

    def _note_memory(self, prog):
        """``prog.memory``: the argument bytes (parameters, accumulators,
        the staged inputs) and, on the card, the allocator's watermark now
        (after the first run and capture)."""
        arg = sum(t.numel() * t.element_size() for t in self._state_tensors())
        arg += sum(t.numel() * t.element_size()
                   for t in prog.inputs.dev.values())
        prog.memory = {"argument_bytes": arg}
        if self.device.type == "cuda":
            prog.memory["peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)

    @contextlib.contextmanager
    def _eager(self):
        """Within: every step runs its body without capture or replay. The
        reference a replay is held to on the card; not a user option."""
        prev, self._bodies_only = self._bodies_only, True
        try:
            yield self
        finally:
            self._bodies_only = prev

    @contextlib.contextmanager
    def _undone_on_failure(self, prog):
        """Within: a call that may capture ``prog``. When a capture is due,
        the state is copied to the host first and restored if the call
        raises (the first run has updated it by then)."""
        if (self.device.type != "cuda" or self._bodies_only
                or prog.capture is not None):
            yield
            return
        saved = self._copy_state(lambda t: t.detach().to("cpu", copy=True))
        try:
            yield
        except BaseException:
            self.import_state(saved)
            raise

    # ---------------------------------------------------------- public api
    # one fingerprint definition shared with the serving warmup (the
    # monitor's recompile sentinel reads it, as in JAX :541)
    _arg_avals = staticmethod(aval_fingerprint)

    def __call__(self, *args, **kwargs):
        mon = self._monitor
        t0 = mon.step_begin() if mon is not None else None
        args, kwargs = _unwrapped((args, kwargs))
        prog = self._program(args, kwargs)
        opt = self.optimizer
        if mon is not None:
            # a call off the primed fingerprint: JAX's aot_fallback (:547)
            mon.before_launch(self, args, kwargs,
                              self._compiled_avals is not None
                              and self._arg_avals(args, kwargs)
                              == self._compiled_avals, t0)
        with self._undone_on_failure(prog):
            opt._step_count += 1
            self._seed += 1
            self._fill(prog, args, kwargs, step=opt._step_count,
                       lr=np.float32(opt.get_lr()))
            (loss, outs), replayed = self._run(prog)
        if replayed:
            loss, outs = loss.clone(), _map_tensors(torch.Tensor.clone, outs)
        if mon is not None:
            mon.step_end(self, loss, t0)
        return (loss, outs) if self._return_outputs else loss

    def run_steps(self, n_steps: int, *args, stacked=False, **kwargs):
        """``n_steps`` steps -> their losses, a device tensor [n_steps].

        ``stacked=True``: every positional argument carries a leading dim
        of ``n_steps``, one slice per step (copied on the device into the
        step's buffer); otherwise the same batch serves every step. The
        counters and the rate (the optimizer's current one, as n calls
        would read it without a scheduler step between them) reach the
        device in one copy; nothing waits on the host between steps. Equal
        to ``n_steps`` sequential calls (JAX :288-360)."""
        if self._return_outputs:
            raise ValueError("run_steps does not support return_outputs=True")
        mon = self._monitor
        t0 = mon.step_begin() if mon is not None else None
        args, kwargs = _unwrapped((args, kwargs))
        given = args
        if stacked:
            stacks = []
            for a in args:
                if (not isinstance(a, (torch.Tensor, np.ndarray))
                        or a.ndim == 0 or a.shape[0] != n_steps):
                    raise ValueError(
                        f"stacked=True: every batch arg needs leading dim "
                        f"{n_steps}, got {getattr(a, 'shape', type(a))}")
                stacks.append(torch.as_tensor(a).to(self.device))
            args = tuple(s[0] for s in stacks)
        prog = self._program(args, kwargs)
        if mon is not None:
            mon.before_scan_launch(self, n_steps,
                                   tuple(bool(stacked) for _ in given),
                                   given, kwargs, t0)
        opt = self.optimizer
        steps = np.arange(opt._step_count + 1, opt._step_count + 1 + n_steps,
                          dtype=np.int32)
        lrs = np.full(n_steps, opt.get_lr(), dtype=np.float32)
        sched = torch.from_numpy(np.concatenate(
            [steps.view(np.uint8), lrs.view(np.uint8)])).to(self.device)
        step_dev = sched[:4 * n_steps].view(torch.int32)
        lr_dev = sched[4 * n_steps:].view(torch.float32)
        with self._undone_on_failure(prog):
            opt._step_count += n_steps
            self._seed += n_steps
            self._fill(prog, args, kwargs)
            inp = prog.inputs.dev
            losses = None
            for i in range(n_steps):
                inp["step"].copy_(step_dev[i])
                inp["lr"].copy_(lr_dev[i])
                if stacked:
                    for j, s in enumerate(stacks):
                        inp[f"a{j}"].copy_(s[i])
                (loss, _), _ = self._run(prog)
                if losses is None:
                    losses = torch.empty(n_steps, dtype=loss.dtype,
                                         device=loss.device)
                losses[i].copy_(loss)
        if mon is not None:
            mon.step_end(self, losses[-1], t0, n_steps=n_steps)
        return losses

    def aot_prime(self, *args, **kwargs):
        """Prepare the step of this batch's key ahead of its first call: on
        CUDA capture it (a body run first, as a first call does), and count
        one step's FLOPs. The parameters, accumulators, step counter, seed,
        RNG and scheduler are left as they were (the run is undone by
        ``import_state``), so the next call replays. Returns the
        ``StepProgram`` (``.flops``, ``.memory``), which becomes the
        step's ``_compiled`` (a later call of another fingerprint is the
        monitor's ``aot_fallback``)."""
        args, kwargs = _unwrapped((args, kwargs))
        prog = self._program(args, kwargs)
        opt = self.optimizer
        if prog.flops is None or (self.device.type == "cuda"
                                  and prog.capture is None
                                  and not self._bodies_only):
            saved = self.export_state()
            try:
                self._fill(prog, args, kwargs, step=opt._step_count + 1,
                           lr=np.float32(opt.get_lr()))
                self._run(prog, count_flops=prog.flops is None)
            finally:
                self.import_state(saved)
        if prog.memory is None:
            self._note_memory(prog)
        self._compiled = prog
        self._compiled_avals = self._arg_avals(args, kwargs)
        return prog

    def lowered(self, *args, **kwargs):
        raise NotImplementedError(
            "TrainStep.lowered: a CUDA graph has no program text to lower; "
            "aot_prime(...).flops gives one step's FLOP count")

    def lowered_steps(self, n_steps, *args, stacked=False, **kwargs):
        raise NotImplementedError(
            "TrainStep.lowered_steps: a CUDA graph has no program text to "
            "lower; aot_prime(...).flops gives one step's FLOP count")

    # ------------------------------------------------- checkpoint state
    def _rng_state(self):
        rng = {"cpu": torch.get_rng_state().tolist(),
               "generator": default_generator(self.device).get_state()
               .tolist()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device).tolist()
        return rng

    def export_state(self):
        """Copies of everything a bit-exact resume needs: ``params`` (the
        model's state dict), ``acc`` ({accumulator: {param name: tensor}},
        created first if missing, as JAX :370-398 does), ``master`` (the
        eager path's f32 masters, when any) and ``meta`` (``step_count``,
        ``seed``, ``rng`` (torch's global states and the port's default
        generator of the device, which dropout draws from), ``lr_sched``
        under a scheduler and ``monitor``, a bound monitor's counters)."""
        return self._copy_state(lambda t: t.detach().clone())

    def _copy_state(self, copy):
        """``export_state``'s record with every tensor made by ``copy``."""
        opt = self.optimizer
        opt._materialize_accumulators(self._params)
        with torch.no_grad():
            state = {
                "params": {k: copy(t) for k, t in
                           self.model.state_dict(keep_vars=True).items()},
                "acc": {name: {k: copy(store[id(p)])
                               for k, p in self._trainable.items()
                               if id(p) in store}
                        for name, store in opt._accumulators.items()},
            }
            masters = {k: copy(opt._master_weights[id(p)])
                       for k, p in self._trainable.items()
                       if id(p) in opt._master_weights}
        if masters:
            state["master"] = masters
        meta = {"step_count": int(opt._step_count), "seed": int(self._seed),
                "rng": self._rng_state()}
        if isinstance(opt._learning_rate, LRScheduler):
            meta["lr_sched"] = opt._learning_rate.state_dict()
        counters = getattr(self._monitor, "export_counters", None)
        if counters is not None:
            meta["monitor"] = counters()
        state["meta"] = meta
        return state

    def import_state(self, state):
        """The reverse of ``export_state`` (JAX :432-483): every value is
        copied INTO the live tensor it replaces, in that tensor's dtype, so
        a captured step replays on the restored state without a new
        capture; counters, RNG and scheduler state are set."""
        opt = self.optimizer
        opt._materialize_accumulators(self._params)
        live = self.model.state_dict(keep_vars=True)
        with torch.no_grad():
            for k, v in (state.get("params") or {}).items():
                if k in live:
                    live[k].copy_(_as_tensor(v))
            for name, per in (state.get("acc") or {}).items():
                store = opt._accumulators.setdefault(name, {})
                for k, v in per.items():
                    p = self._trainable.get(k)
                    if p is None:
                        continue
                    if id(p) in store:
                        store[id(p)].copy_(_as_tensor(v))
                    else:
                        store[id(p)] = _as_tensor(v).to(p.device).clone()
            for k, v in (state.get("master") or {}).items():
                p = self._trainable.get(k)
                if p is None:
                    continue
                cur = opt._master_weights.get(id(p))
                if cur is not None:
                    cur.copy_(_as_tensor(v))
                else:
                    opt._master_weights[id(p)] = _as_tensor(v).to(
                        p.device, torch.float32).clone()
        meta = state.get("meta") or {}
        if "step_count" in meta:
            opt._step_count = int(meta["step_count"])
        if "seed" in meta:
            self._seed = int(meta["seed"])
        rng = meta.get("rng") or {}
        if "cpu" in rng:
            torch.set_rng_state(torch.tensor(rng["cpu"], dtype=torch.uint8))
        if "cuda" in rng and self.device.type == "cuda":
            torch.cuda.set_rng_state(
                torch.tensor(rng["cuda"], dtype=torch.uint8), self.device)
        if "generator" in rng:
            default_generator(self.device).set_state(
                torch.tensor(rng["generator"], dtype=torch.uint8))
        if ("lr_sched" in meta
                and isinstance(opt._learning_rate, LRScheduler)):
            opt._learning_rate.set_state_dict(meta["lr_sched"])
        if "monitor" in meta:
            if self._monitor is not None:
                importer = getattr(self._monitor, "import_counters", None)
                if importer is not None:
                    importer(meta["monitor"])
            else:
                # no monitor bound yet (fit binds through MonitorCallback
                # on the first batch, after the restore): park them
                self._pending_monitor_counters = dict(meta["monitor"])
