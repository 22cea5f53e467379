"""``DataParallel`` — the counterpart of
``paddle_tpu/distributed/parallel.py`` (Paddle ``parallel.py:219`` and
its C++ Reducer) — and the gradient sync it shares with the hybrid
wrappers ``TensorParallel`` and ``SegmentParallel``.

The JAX package shards one global batch over a "dp" mesh and lets the
gradient's reduction fall out of the compiled program (:47-62). In the
port each rank passes its own batch, as in Paddle, and the gradients are
averaged over the data-parallel group after the backward: the wrapper's
forward leaves a hook on its output that queues, when the backward reaches
it, a callback run at the backward's end (``GradientSync``). The callback
scales every parameter's gradient by the rank's share of the global batch,
b_r / sum(b), and sums them over the group, in place and in their own
dtype (one coalesced all-reduce per dtype): the gradients become those of
the mean loss over the global batch even when the ranks' batches differ in
size (the local batch size is the leading dimension of the first tensor
argument). The batch total is all-reduced on the device and the scaling is
one ``_foreach_mul_``, with no host read, so inside a captured
``jit.TrainStep`` the sync is part of the graph (NCCL captures; gloo runs
on the CPU, where nothing is captured). At one rank nothing is scaled and
the all-reduce leaves the gradients bit for bit.

The hybrid wrappers sync over the data x segment-parallel group (each sep
rank's loss is the mean over its sequence segment, so the share of a sep
rank is b_r / (sep * sum over dp of b)), after summing over the
model-parallel group the gradients of parameters marked
``sequence_parallel`` (each mp rank saw only its sequence slice).

The gradients of parameters a ZeRO stage averages over the same group
(``sharding.owns``) are left to the stage: each axis has one sync.

Parameters and buffers are broadcast from the group's first rank when the
model is wrapped. ``no_sync`` skips the all-reduce (gradients accumulate
locally until a backward outside it, or ``apply_collective_grads``);
``scale_loss`` is the identity: the all-reduce already averages.
"""
from __future__ import annotations

import contextlib

import torch

from ..nn.layer import Layer
from ..tensor import Tensor
from .collective import (
    _all_reduce_,
    _all_reduce_coalesced_,
    _get_group,
    broadcast,
)
from .sharding import owns

__all__ = ["DataParallel", "GradientSync"]


def _first_tensor(tree):
    if isinstance(tree, Tensor):
        return tree._value
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, (list, tuple)):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    if isinstance(tree, dict):
        return _first_tensor(list(tree.values()))
    return None


class GradientSync(Layer):
    """A model wrapper whose backward ends with the gradient sync: the
    gradients of ``sequence_parallel`` parameters summed over ``sp_group``,
    then every gradient averaged over ``group`` weighted by the ranks'
    batches (no average without a group)."""

    def __init__(self, layers, group, sp_group=None):
        super().__init__()
        self._layers = layers
        self.group = group
        self._sp_group = sp_group
        # a torch model takes torch tensors in TrainStep, a Layer Tensors
        self._paddle_io = isinstance(layers, Layer)
        self._sync = True
        self._pending = False       # a backward ran under no_sync
        self._local_batch = None
        self.syncs = 0              # gradient syncs issued

    def _grad_params(self):
        return [p for p in torch.nn.Module.parameters(self._layers)
                if p.requires_grad]

    def forward(self, *inputs, **kwargs):
        first = _first_tensor((inputs, kwargs))
        self._local_batch = (1 if first is None or first.dim() == 0
                             else int(first.shape[0]))
        out = self._layers(*inputs, **kwargs)
        if torch.is_grad_enabled():
            self._hook(out)
        return out

    def _hook(self, out):
        """Queue the gradient sync at the end of the backward that reaches
        ``out``."""
        t = _first_tensor(out)
        if t is None or not t.requires_grad:
            return

        def queue(grad):
            torch.autograd.Variable._execution_engine.queue_callback(
                self._after_backward)
            return grad

        t.register_hook(queue)

    def _after_backward(self):
        if self._sync:
            self._all_reduce_grads()
        else:
            self._pending = True

    @torch.no_grad()
    def _all_reduce_grads(self):
        params = self._grad_params()
        if not params:
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sp = self._sp_group
        if sp is not None and sp.nranks > 1:
            marked = [p.grad for p in params
                      if getattr(p, "sequence_parallel", False)]
            if marked:
                _all_reduce_coalesced_(marked, sp)
        g = self.group
        if g is not None:
            # a ZeRO stage averages its parameters over this group itself
            grads = [p.grad for p in params if not owns(p, g)]
        if g is not None and grads:
            if g.nranks > 1:
                b = torch.full((), float(self._local_batch or 1),
                               dtype=torch.float32, device=grads[0].device)
                total = b.clone()
                _all_reduce_(total, "sum", g)
                torch._foreach_mul_(grads, b / total)
            _all_reduce_coalesced_(grads, g)
        self._pending = False
        self.syncs += 1

    # ---------------------------------------------------------- paddle api
    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """All-reduce gradients left local by a backward under
        ``no_sync``."""
        if self._pending:
            self._all_reduce_grads()

    @contextlib.contextmanager
    def no_sync(self):
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)


class DataParallel(GradientSync):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__(layers, _get_group(group))
        self.find_unused_parameters = find_unused_parameters
        with torch.no_grad():
            for t in list(self._grad_params()) + list(
                    torch.nn.Module.buffers(layers)):
                broadcast(t, src=self.group.ranks[0], group=self.group)
