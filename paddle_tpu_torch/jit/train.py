"""TrainStep — the counterpart of ``paddle_tpu/jit/train.py``.

The JAX package compiles forward, backward, clipping and the optimizer
update into one XLA program. PyTorch runs eagerly, so here one call is the
same sequence of launches: the forward, ``loss.backward()``, the global-norm
clip of the optimizer's ``_grad_clip`` (``_functional_clip`` :29-36), and
the optimizer's update rule applied to every trainable parameter IN ITS OWN
DTYPE (:201-212), with the learning rate an f32 tensor and the step counter
an int32 tensor, as they are traced there. So under O2 the parameters, the
moments and the update are bf16 even when the optimizer was built with
``multi_precision``: the JAX TrainStep keeps no master weights (the eager
``Optimizer.step`` does).

Not ported yet: AOT priming, ``run_steps`` (a ``lax.scan`` of steps), ZeRO
stages, ``StepMonitor`` and ``export_state`` / ``import_state``.
"""
from __future__ import annotations

import inspect
from typing import Callable

import torch

from ..nn.clip import ClipGradByGlobalNorm

__all__ = ["TrainStep"]


class TrainStep:
    """loss = step(*batch): one training step of ``model`` under
    ``optimizer``.

    Batch convention (:118-130): when the model's forward can bind every
    argument it gets them all (``GPTForCausalLM(ids, labels=...)``, whose
    output goes to ``loss_fn(*outputs)``); otherwise the last positional
    argument is the label and goes to ``loss_fn(outputs, label)``."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._fwd_sig = inspect.signature(type(model).forward)
        self._params = [p for p in model.parameters()
                        if p.requires_grad and p.is_floating_point()]

    def _split(self, args, kwargs):
        try:
            self._fwd_sig.bind(self.model, *args, **kwargs)
        except TypeError:
            return args[:-1], args[-1]
        return args, None

    def _clip(self, grads):
        clip = self.optimizer._grad_clip
        if clip is None:
            return grads
        if not isinstance(clip, ClipGradByGlobalNorm):
            raise NotImplementedError(
                f"TrainStep clips by global norm only, got {type(clip)}")
        return clip.clip(grads)

    def __call__(self, *args, **kwargs):
        opt = self.optimizer
        model_args, label = self._split(args, kwargs)
        for p in self._params:
            p.grad = None
        out = self.model(*model_args, **kwargs)
        if label is not None:
            loss = self.loss_fn(out, label)
        elif isinstance(out, (tuple, list)):
            loss = self.loss_fn(*out)
        else:
            loss = self.loss_fn(out)
        loss.backward()
        grads = self._clip([p.grad if p.grad is not None
                            else torch.zeros_like(p) for p in self._params])
        opt._step_count += 1
        dev = self._params[0].device
        step = torch.tensor(opt._step_count, dtype=torch.int32, device=dev)
        lr = torch.tensor(opt.get_lr(), dtype=torch.float32, device=dev)
        with torch.no_grad():
            for p, g in zip(self._params, grads):
                p.grad = None
                p.copy_(opt._update(p, p.detach(), g.to(p.dtype), lr, step))
        return loss.detach()
