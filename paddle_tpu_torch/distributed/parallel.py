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
argument). The share is computed in the forward, the batch total
all-reduced on the device, and the scaling is one ``_foreach_mul_``, with
no host read, so inside a captured ``jit.TrainStep`` the sync is part of
the graph (NCCL captures; gloo runs on the CPU, where nothing is
captured). At one rank nothing is scaled and the all-reduce leaves the
gradients bit for bit.

The hybrid wrappers sync over the data x segment-parallel group (each sep
rank's loss is the mean over its sequence segment, so the share of a sep
rank is b_r / (sep * sum over dp of b)), after summing over the
model-parallel group the gradients of parameters marked
``sequence_parallel`` (each mp rank saw only its sequence slice).

The gradients of parameters a ZeRO stage averages over the same group
(``sharding.owns``) are left to the stage: each axis has one sync.

An expert parameter of an expert-parallel ``MoELayer`` (it carries
``_expert_group``: the ranks that hold the same experts) is scaled like
the others and summed over that group only: each rank's experts saw the
tokens its expert group routed to them, and the ranks outside the group
hold other experts. Summing it over the whole group would add other
experts' gradients to it. Its gradient on a rank sums what every rank of
the expert-parallel group sent back for its tokens, so those layers whose
backward crosses ranks (they carry ``_loss_share``: the MoE exchange, the
gate's balance statistics) are given the share in the forward, and a
gradient leaving a rank is scaled by its share and divided by the
receiver's on arrival: after the sync's scaling each rank's loss carries
its own weight, also when the ranks' batches differ.

Parameters and buffers are broadcast from the group's first rank when the
model is wrapped (an expert parameter from its expert group's first), and
the model's ``SyncBatchNorm`` layers without a group take this one.
``no_sync`` skips the all-reduce (gradients accumulate locally until a
backward outside it, or ``apply_collective_grads``); ``scale_loss`` is
the identity: the all-reduce already averages.
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
        self._share = None          # b_r / sum(b), set by the forward
        # layers whose backward crosses ranks: they weight what they send
        self._crossing = [m for m in torch.nn.Module.modules(layers)
                          if hasattr(m, "_loss_share")]
        self.syncs = 0              # gradient syncs issued

    def _grad_params(self):
        return [p for p in torch.nn.Module.parameters(self._layers)
                if p.requires_grad]

    def forward(self, *inputs, **kwargs):
        if torch.is_grad_enabled():
            self._set_share(_first_tensor((inputs, kwargs)))
        out = self._layers(*inputs, **kwargs)
        if torch.is_grad_enabled():
            self._hook(out)
        return out

    def _set_share(self, first):
        """This rank's share of the group's batch, b_r / sum(b), on the
        device (None without a group of more than one rank), also given
        to the layers whose backward crosses ranks."""
        g = self.group
        share = None
        if g is not None and g.nranks > 1:
            b = 1 if first is None or first.dim() == 0 else first.shape[0]
            dev = (first.device if first is not None
                   else self._grad_params()[0].device)
            share = torch.full((), float(b), dtype=torch.float32, device=dev)
            total = share.clone()
            _all_reduce_(total, "sum", g)
            share = share / total
        self._share = share
        for m in self._crossing:
            m._loss_share = share

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
            mine = [p for p in params if not owns(p, g)]
            grads = [p.grad for p in mine
                     if getattr(p, "_expert_group", None) is None]
            experts = {}
            for p in mine:
                eg = getattr(p, "_expert_group", None)
                if eg is not None:
                    experts.setdefault(id(eg), (eg, []))[1].append(p.grad)
        if g is not None and (grads or experts):
            if g.nranks > 1 and self._share is not None:
                torch._foreach_mul_(
                    grads + [t for _, ts in experts.values() for t in ts],
                    self._share)
            if grads:
                _all_reduce_coalesced_(grads, g)
            for eg, ts in experts.values():
                _all_reduce_coalesced_(ts, eg)
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
        from ..nn.layer_conv_norm import SyncBatchNorm

        for m in torch.nn.Module.modules(layers):
            if isinstance(m, SyncBatchNorm) and m._group is None:
                m._group = self.group
        with torch.no_grad():
            for t in list(self._grad_params()) + list(
                    torch.nn.Module.buffers(layers)):
                # an expert's copies are on the ranks holding its experts
                g = getattr(t, "_expert_group", None) or self.group
                broadcast(t, src=g.ranks[0], group=g)
