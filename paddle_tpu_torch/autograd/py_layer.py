"""PyLayer: a user-defined forward and backward — the counterpart of
``paddle_tpu/autograd/py_layer.py``, over ``torch.autograd.Function``.

``PyLayer.apply`` runs the user's ``forward(ctx, *args)`` on Tensors (with
grad off, as both backends do) inside one generic ``torch.autograd
.Function``; its ``backward`` calls the user's ``backward(ctx, *grads)``
with Tensors. Paddle's names stand on the context: ``ctx
.save_for_backward(*tensors)`` keeps tensors through torch's own saving
(so ``autograd.saved_tensors_hooks`` sees them) and ``ctx.saved_tensor()``
gives them back. The user's backward returns one gradient per tensor
argument, or one per argument that needs a gradient, as in JAX.
"""
from __future__ import annotations

import torch

from ..tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext"]


def _raw(x):
    return x._value if isinstance(x, Tensor) else x


class PyLayerContext:
    def __init__(self):
        self._tctx = None
        self._plain = None      # saved objects that are not all tensors
        self._single = True     # forward returned one tensor, not a tuple
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        if all(isinstance(t, (Tensor, torch.Tensor)) for t in tensors):
            self._tctx.save_for_backward(*[_raw(t) for t in tensors])
            self._plain = None
        else:
            self._plain = list(tensors)

    def saved_tensor(self):
        if self._plain is not None:
            return list(self._plain)
        return [Tensor(t) for t in self._tctx.saved_tensors]

    saved_tensors = property(lambda self: self.saved_tensor())


class _Bridge(torch.autograd.Function):
    """forward(layer, ctx, kwargs, is_tensor, *flat): the user's layer on
    Tensors; backward maps its gradients back onto the flat arguments."""

    @staticmethod
    def forward(tctx, layer, pctx, kwargs, is_tensor, *flat):
        pctx._tctx = tctx
        tctx.pctx, tctx.layer, tctx.is_tensor = pctx, layer, is_tensor
        args = [Tensor(v) if t else v for v, t in zip(flat, is_tensor)]
        try:
            out = layer.forward(pctx, *args, **kwargs)
        finally:
            pctx._tctx = None   # no cycle between the context and the node
        pctx._single = not isinstance(out, (tuple, list))
        outs = [out] if pctx._single else list(out)
        return tuple(_raw(o) for o in outs)

    @staticmethod
    def backward(tctx, *grads):
        tctx.pctx._tctx = tctx
        try:
            res = tctx.layer.backward(
                tctx.pctx, *[None if g is None else Tensor(g) for g in grads])
        finally:
            tctx.pctx._tctx = None
        res = list(res) if isinstance(res, (tuple, list)) else [res]
        res = [None if r is None else _raw(r) for r in res]
        n = len(tctx.is_tensor)
        needs = tctx.needs_input_grad[4:]
        tensor_pos = [i for i in range(n) if tctx.is_tensor[i]]
        diff_pos = [i for i in tensor_pos if needs[i]]
        if len(res) == len(tensor_pos):
            pos = tensor_pos
        elif len(res) == len(diff_pos):
            pos = diff_pos
        else:
            raise RuntimeError(
                f"{tctx.layer.__name__}.backward returned {len(res)} "
                f"gradients for {len(tensor_pos)} tensor inputs")
        flat = [None] * n
        for i, g in zip(pos, res):
            flat[i] = g if needs[i] else None
        return (None, None, None, None, *flat)


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        flat = [_raw(a) for a in args]
        is_tensor = tuple(isinstance(a, torch.Tensor) for a in flat)
        ctx = PyLayerContext()
        outs = _Bridge.apply(cls, ctx, kwargs, is_tensor, *flat)
        wrapped = [Tensor(o) for o in outs]
        return wrapped[0] if ctx._single else tuple(wrapped)
