"""Autograd — the counterpart of ``paddle_tpu/autograd/`` (``tape.py``,
``__init__.py``, ``py_layer.py``).

The JAX package keeps a tape of ``jax.vjp`` closures; here the tape IS
torch's autograd graph, reached through the Tensor wrapper's ``_value``.
``backward`` and ``grad`` unwrap, call ``torch.autograd``, and wrap what
comes back; the grad-mode switches are torch's own. ``jacobian`` and
``hessian`` take the functional form (``torch.autograd.functional``) or,
for ``jacobian``, a tensor computed from the inputs, one backward per
output element as the JAX package does. ``saved_tensors_hooks`` is
``torch.autograd.graph.saved_tensors_hooks`` with the hooks seeing
Tensors.
"""
from __future__ import annotations

import torch

from ..tensor import Tensor

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "jacobian", "hessian", "saved_tensors_hooks",
           "PyLayer", "PyLayerContext"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _raw(x):
    return x._value if isinstance(x, Tensor) else x


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward`` / ``Tensor.backward``: gradients of
    ``tensors`` (seeded by ``grad_tensors``, ones for a one-element tensor)
    accumulate into the leaves' ``.grad``. Tensors that stop the gradient
    are skipped, as the JAX tape skips them; a second backward through a
    freed graph raises RuntimeError."""
    tensors = _as_list(tensors)
    grads = ([None] * len(tensors) if grad_tensors is None
             else _as_list(grad_tensors))
    outs, seeds = [], []
    for t, g in zip(tensors, grads):
        if t.stop_gradient:
            continue
        v = _raw(t)
        if g is None:
            if v.numel() != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar outputs;"
                    f" tensor has shape {list(v.shape)}")
            g = torch.ones_like(v)
        outs.append(v)
        seeds.append(_raw(g) if isinstance(g, (Tensor, torch.Tensor))
                     else torch.as_tensor(g, dtype=v.dtype, device=v.device))
    if outs:
        torch.autograd.backward(outs, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` (leaves or intermediates), leaving every ``.grad`` as it
    was. An input no output reaches raises unless ``allow_unused``."""
    outs = [_raw(t) for t in _as_list(outputs)]
    ins = _as_list(inputs)
    seeds = (None if grad_outputs is None
             else [None if g is None else _raw(g)
                   for g in _as_list(grad_outputs)])
    try:
        gs = torch.autograd.grad(
            outs, [_raw(t) for t in ins], grad_outputs=seeds,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=allow_unused)
    except RuntimeError as e:
        if "appears to not have been used" in str(e):
            raise RuntimeError(
                "gradient of an input is None (not reachable from outputs); "
                "pass allow_unused=True to return None instead") from e
        raise
    return [None if g is None else Tensor(g, stop_gradient=not create_graph)
            for g in gs]


def jacobian(ys, xs, batch_axis=None):
    """The full Jacobian. ``ys`` a function: ``torch.autograd.functional
    .jacobian`` of it at ``xs``; ``ys`` a Tensor computed from ``xs``: one
    backward per element of ``ys`` (the graph is kept between them).
    Returns ``[ys.shape + x.shape]`` per input (a list when ``xs`` is)."""
    many = isinstance(xs, (list, tuple))
    xs_l = _as_list(xs)
    if callable(ys):
        fn = ys

        def raw(*vals):
            return _raw(fn(*[Tensor(v) for v in vals]))

        jac = torch.autograd.functional.jacobian(
            raw, tuple(_raw(x).detach() for x in xs_l))
        outs = [Tensor(j) for j in jac]
        return outs if many else outs[0]
    y = _raw(ys).reshape(-1)
    rows = [[] for _ in xs_l]
    for i in range(y.numel()):
        gs = torch.autograd.grad(y[i], [_raw(x) for x in xs_l],
                                 retain_graph=True, allow_unused=True)
        for slot, g, x in zip(rows, gs, xs_l):
            slot.append(torch.zeros_like(_raw(x)) if g is None else g)
    outs = [Tensor(torch.stack([r.reshape(-1) for r in slot])
                   .reshape(tuple(ys.shape) + tuple(x.shape)))
            for slot, x in zip(rows, xs_l)]
    return outs if many else outs[0]


def hessian(func, xs, batch_axis=None):
    """The Hessian of ``func(*xs).sum()``: one Tensor for one input, a
    nested list of blocks for a list of inputs."""
    many = isinstance(xs, (list, tuple))
    xs_l = _as_list(xs)

    def raw(*vals):
        return _raw(func(*[Tensor(v) for v in vals])).sum()

    h = torch.autograd.functional.hessian(
        raw, tuple(_raw(x).detach() for x in xs_l))
    if not many:
        return Tensor(h[0][0])
    return [[Tensor(c) for c in row] for row in h]


class saved_tensors_hooks(torch.autograd.graph.saved_tensors_hooks):
    """``paddle.autograd.saved_tensors_hooks``: ``pack_hook(Tensor)`` runs
    on every tensor autograd saves (the ops' residuals and what
    ``PyLayerContext.save_for_backward`` keeps), ``unpack_hook`` gives it
    back when the backward needs it."""

    def __init__(self, pack_hook, unpack_hook):
        def pack(t):
            return pack_hook(Tensor(t))

        def unpack(p):
            return _raw(unpack_hook(p))

        super().__init__(pack, unpack)


from .py_layer import PyLayer, PyLayerContext  # noqa: E402
