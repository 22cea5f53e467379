"""nn.utils — the counterpart of ``paddle_tpu/nn/utils/__init__.py``:
``weight_norm`` / ``remove_weight_norm``, ``spectral_norm``,
``parameters_to_vector`` / ``vector_to_parameters``, and the gradient
clips ``clip_grad_norm_`` / ``clip_grad_value_`` (``nn/clip.py``).

``weight_norm`` replaces ``layer.<name>`` by parameters ``<name>_g`` and
``<name>_v`` and recomputes the weight g * v / ||v|| before each forward
(a forward pre-hook); ``spectral_norm`` divides the weight by its largest
singular value, estimated by power iteration on the host before each
forward, as JAX's does.
"""
from __future__ import annotations

import numpy as np
import torch

from ...tensor import Tensor
from ..clip import clip_grad_norm_, clip_grad_value_
from ..layer import Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]


def _weight_from(v, g, dim):
    """g * v / ||v||, the norm over every axis but ``dim`` (None: all)."""
    from ...ops import apply_op

    def f(vv, gg):
        if dim is None:
            return vv / torch.clamp(torch.linalg.vector_norm(vv),
                                    min=1e-12) * gg
        d = dim % vv.dim()
        axes = tuple(i for i in range(vv.dim()) if i != d)
        shape = [1] * vv.dim()
        shape[d] = -1
        nrm = torch.sqrt(torch.sum(torch.square(vv), dim=axes, keepdim=True))
        return vv / torch.clamp(nrm, min=1e-12) * gg.reshape(shape)

    return apply_op(f, "weight_norm", v, g)


def weight_norm(layer, name="weight", dim=0):
    w = getattr(layer, name)._value.detach()
    if dim is None:
        g0 = torch.linalg.vector_norm(w)
    else:
        d = dim % w.dim()
        g0 = torch.sqrt(torch.sum(torch.square(w), dim=tuple(
            i for i in range(w.dim()) if i != d))).reshape(-1)
    del layer._parameters[name]
    layer._wrappers.pop(name, None)
    layer.add_parameter(name + "_g", Parameter(g0.clone()))
    layer.add_parameter(name + "_v", Parameter(w.clone()))

    def hook(lyr, inputs):
        lyr.__dict__[name] = _weight_from(getattr(lyr, name + "_v"),
                                          getattr(lyr, name + "_g"), dim)

    layer._weight_norm = (layer.register_forward_pre_hook(hook), dim)
    return layer


def remove_weight_norm(layer, name="weight"):
    if name + "_v" not in layer._parameters:
        return layer
    handle, dim = layer.__dict__.pop("_weight_norm")
    handle.remove()
    w = _weight_from(getattr(layer, name + "_v"), getattr(layer, name + "_g"),
                     dim)._value.detach()
    for suffix in ("_v", "_g"):
        del layer._parameters[name + suffix]
        layer._wrappers.pop(name + suffix, None)
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(w.clone()))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """The parameter stays ``layer.<name>`` in the state dict; the forward
    reads the normalised weight, which shadows it as a plain attribute."""
    dim = 0 if dim is None else dim
    state = {"u": None}

    def hook(lyr, inputs):
        wv = lyr._wrapped(name, lyr._parameters[name], Parameter)
        mat = np.moveaxis(wv.numpy(), dim, 0).reshape(wv.shape[dim], -1)
        if state["u"] is None:
            state["u"] = np.random.default_rng(0).standard_normal(
                mat.shape[0]).astype(np.float32)
        u = state["u"]
        for _ in range(n_power_iterations):
            v = mat.T @ u
            v = v / max(np.linalg.norm(v), eps)
            u = mat @ v
            u = u / max(np.linalg.norm(u), eps)
        state["u"] = u
        sigma = float(u @ mat @ v)
        lyr.__dict__[name] = wv / sigma

    layer.register_forward_pre_hook(hook)
    return layer


def parameters_to_vector(parameters, name=None):
    from ...ops.manipulation import concat, reshape

    return concat([reshape(p, [-1]) for p in parameters], axis=0)


def vector_to_parameters(vec, parameters, name=None):
    """Each parameter takes its slice of ``vec`` (into its own storage)."""
    v = vec._value if isinstance(vec, Tensor) else vec
    offset = 0
    for p in parameters:
        n = p.size
        p.set_value(v[offset:offset + n].reshape(p.shape))
        offset += n
