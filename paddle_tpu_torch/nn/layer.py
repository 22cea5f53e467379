"""Layer, Parameter and ParamAttr — the counterpart of
``paddle_tpu/nn/layer.py`` (``ParamAttr`` :22-53, ``Parameter`` :56-69,
``Layer`` :71-384).

The design decision: ``Layer`` IS a ``torch.nn.Module``, and a paddle
``Parameter`` is a view of a ``torch.nn.Parameter``, never a second copy.

* A layer's parameters live where torch keeps them, ``_parameters``, as
  ``torch.nn.Parameter`` objects: ``.to``, ``state_dict(keep_vars=True)``,
  ``jit.TrainStep`` (which keys its captured step on their addresses), CUDA
  graphs, ``amp.decorate`` (``p.data = ...``) and the torch-level models
  that hold the port's ``Embedding`` / ``LayerNorm`` / ``RMSNorm`` /
  ``Dropout`` see plain torch.
* ``layer.weight``, ``parameters()``, ``named_parameters()`` and the
  paddle ``state_dict()`` return a ``Parameter``: a subclass of the port's
  ``Tensor`` whose ``_value`` IS that ``torch.nn.Parameter``. One wrapper
  per parameter is cached on its layer, so it keeps its identity and its
  paddle attributes (``trainable``, ``optimize_attr``, ``regularizer``,
  ``need_clip``); shapes are lists, ``.numpy()`` and ``stop_gradient``
  work. Gradients land on the torch parameter and ``.grad`` reads them.
  Writes through the wrapper (``set_value``, ``copy_``, an optimizer's
  update) go into the torch parameter's own storage, so nothing that
  holds its address goes stale.
* Buffers (batch norm's ``_mean`` / ``_variance``) are torch buffers
  (``persistable`` is torch's ``persistent``); ``layer._mean`` is a cached
  ``Tensor`` over the buffer.

The torch signatures stay callable where torch itself calls them on a
child module: ``state_dict(prefix=..., keep_vars=...)``,
``named_parameters(recurse=...)``, ``parameters(recurse=...)``,
``named_buffers`` / ``buffers`` likewise return torch's results. Called
the paddle way they return the wrappers under JAX's structured names
(``layer1.0.conv1.weight``, ``bn1._mean``). The optimizers take either
the wrappers or bare torch tensors.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..framework import dtype as _dt
from ..tensor import Tensor, _resolve_place
from . import initializer as I

__all__ = ["Layer", "Parameter", "ParamAttr", "make_parameter"]


class ParamAttr:
    """Reference: python/paddle/base/param_attr.py."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")


class Parameter(Tensor):
    """A trainable Tensor (``stop_gradient`` False by default) over a
    ``torch.nn.Parameter``. Writes go into that parameter's storage (or,
    for a new dtype or shape, its ``.data``), so the torch object never
    changes."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "need_clip",
                 "is_distributed")

    def __init__(self, value, trainable=True, name=None):
        if isinstance(value, Tensor):
            value = value._value
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        if not isinstance(value, torch.nn.Parameter):
            value = torch.nn.Parameter(
                value.detach(), requires_grad=bool(trainable) and (
                    value.is_floating_point() or value.is_complex()))
        super().__init__(value, stop_gradient=not trainable, name=name)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False
        self.persistable = True

    def _assign(self, new_value):
        old = self._value
        with torch.no_grad():
            if (new_value.shape == old.shape and new_value.dtype == old.dtype
                    and new_value.device == old.device):
                old.copy_(new_value)
            else:
                old.data = new_value.detach().to(old.device)
        return self


def make_parameter(shape, attr=None, dtype=None, is_bias=False,
                   default_initializer=None, device=None, generator=None):
    """A new Parameter as ``Layer.create_parameter`` makes it (JAX :122-147):
    the attr's initializer, else ``default_initializer``, else the global
    one, else Constant(0) for a bias and XavierUniform for a weight; on
    ``device`` (None: the current place); None when ``attr`` is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    dtype = _dt.convert_dtype(dtype) or _dt.get_default_dtype()
    init = attr.initializer or default_initializer
    if init is None:
        glob = I.get_global_initializer()
        if glob is not None:
            init = glob[1] if (is_bias and glob[1] is not None) else glob[0]
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierUniform()
    value = init(list(shape), dtype, device, generator)
    p = Parameter(value, trainable=attr.trainable, name=attr.name)
    if attr.learning_rate != 1.0:
        p.optimize_attr["learning_rate"] = attr.learning_rate
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


def _state_value(v):
    """A state-dict value as something ``Tensor.set_value`` takes: Tensors
    and torch tensors as they are, anything else as a numpy array (numpy's
    bfloat16 arrays as float32, which holds them exactly)."""
    if isinstance(v, (Tensor, torch.Tensor)):
        return v
    if hasattr(v, "_value"):        # another package's tensor
        v = v._value
    arr = np.asarray(v)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


class Layer(torch.nn.Module):
    """paddle's ``nn.Layer`` as a ``torch.nn.Module`` (see the module
    docstring). ``dtype`` is the dtype ``create_parameter`` gives new
    parameters; its ``device`` (a port extension) says where it puts them
    (None: the current place)."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = _dt.convert_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()
        self._wrappers = {}

    # ---------------------------------------------------- attribute magic
    def __setattr__(self, name, value):
        wrappers = self.__dict__.get("_wrappers")
        if isinstance(value, Parameter):
            super().__setattr__(name, value._value)
            wrappers[name] = value
            return
        buffers = self.__dict__.get("_buffers")
        if (isinstance(value, Tensor) and buffers is not None
                and name in buffers):
            buffers[name] = value._value
            wrappers[name] = value
            return
        if wrappers is not None:
            wrappers.pop(name, None)
        super().__setattr__(name, value)

    def __getattr__(self, name):
        d = self.__dict__
        for store, kind in (("_parameters", Parameter), ("_buffers", Tensor)):
            held = d.get(store)
            if held is not None and name in held:
                t = held[name]
                return None if t is None else self._wrapped(name, t, kind)
        return super().__getattr__(name)

    def __delattr__(self, name):
        self.__dict__["_wrappers"].pop(name, None)
        super().__delattr__(name)

    def _wrapped(self, name, t, kind):
        """The cached wrapper of parameter or buffer ``t`` (rebound to ``t``
        when torch replaced the object, e.g. by ``load_state_dict``)."""
        w = self._wrappers.get(name)
        if type(w) is not kind:
            w = kind(t, trainable=t.requires_grad) if kind is Parameter \
                else kind(t)
            self._wrappers[name] = w
        elif w._value is not t:
            w._value = t
        return w

    # --------------------------------------------------- construction api
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        return make_parameter(shape, attr, dtype or self._dtype, is_bias,
                              default_initializer, device)

    def add_parameter(self, name, parameter):
        if parameter is None:
            self.register_parameter(name, None)
        else:
            setattr(self, name, parameter if isinstance(parameter, Parameter)
                    else Parameter(parameter))
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """paddle's ``persistable`` (or torch's ``persistent``): a buffer
        left out of ``state_dict`` when False."""
        keep = persistable if persistent is None else persistent
        value = tensor._value if isinstance(tensor, Tensor) else tensor
        super().register_buffer(name, value, persistent=keep)
        if isinstance(tensor, Tensor):
            self._wrappers[name] = tensor
        return tensor

    # ----------------------------------------------------------- traversal
    def _walk(self, prefix, include_sublayers):
        if include_sublayers:
            return self.named_modules(prefix=prefix)
        return [(prefix, self)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         include_self=True, **torch_kwargs):
        if torch_kwargs:
            return super().named_parameters(prefix, **torch_kwargs)
        return self._named("_parameters", Parameter, prefix,
                           include_sublayers, dedup=True)

    def parameters(self, include_sublayers=True, **torch_kwargs):
        if torch_kwargs:
            return super().parameters(**torch_kwargs)
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      **torch_kwargs):
        if torch_kwargs:
            return super().named_buffers(prefix, **torch_kwargs)
        return self._named("_buffers", Tensor, prefix, include_sublayers,
                           dedup=True)

    def buffers(self, include_sublayers=True, **torch_kwargs):
        if torch_kwargs:
            return super().buffers(**torch_kwargs)
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def _named(self, store, kind, prefix, include_sublayers, dedup,
               skip_non_persistent=False):
        seen = set()
        for lname, layer in self._walk(prefix, include_sublayers):
            hidden = (layer._non_persistent_buffers_set
                      if skip_non_persistent else ())
            for n, t in getattr(layer, store).items():
                if t is None or n in hidden or (dedup and id(t) in seen):
                    continue
                seen.add(id(t))
                name = f"{lname}.{n}" if lname else n
                yield name, (layer._wrapped(n, t, kind)
                             if isinstance(layer, Layer) else t)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def apply(self, fn):
        """``fn`` on this layer, then on every sublayer (pre-order, as
        paddle; torch's ``apply`` goes children first)."""
        for m in self.sublayers(include_self=True):
            fn(m)
        return self

    # -------------------------------------------------------- mode / casts
    def to(self, device=None, dtype=None, blocking=None, **torch_kwargs):
        if isinstance(device, torch.dtype) or (
                isinstance(device, str)
                and device.lower() in _dt._STR_ALIASES):
            device, dtype = None, device
        if dtype is not None:
            self.astype(dtype)
        if device is not None:
            super().to(device=_resolve_place(device))
        if torch_kwargs:
            super().to(**torch_kwargs)
        return self

    def astype(self, dtype):
        """Every floating parameter and buffer cast to ``dtype`` (the
        torch objects kept); new parameters take it too."""
        d = _dt.convert_dtype(dtype)
        for m in self.sublayers(include_self=True):
            if isinstance(m, Layer):
                m._dtype = d
        super().to(dtype=d)
        return self

    def float(self):
        return self.astype(torch.float32)

    def half(self):
        return self.astype(torch.float16)

    def bfloat16(self):
        return self.astype(torch.bfloat16)

    # ---------------------------------------------------------- state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, **torch_kwargs):
        """paddle's: {structured name: Parameter or buffer Tensor}, every
        parameter first, then the persistable buffers (JAX :244-255).
        Called with torch's ``prefix`` / ``keep_vars`` (torch does so on a
        child module), torch's."""
        if torch_kwargs:
            return super().state_dict(destination=destination,
                                      **torch_kwargs)
        out = (destination if destination is not None
               else collections.OrderedDict())
        prefix = structured_name_prefix.rstrip(".")
        out.update(self._named("_parameters", Parameter, prefix,
                               include_sublayers, dedup=True))
        out.update(self._named("_buffers", Tensor, prefix, include_sublayers,
                               dedup=False, skip_non_persistent=True))
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Each entry copied into the parameter or buffer of its name (in
        that tensor's dtype, into its storage); returns (missing,
        unexpected) names."""
        own = self.state_dict()
        unexpected = []
        for k, v in state_dict.items():
            if k in own:
                t = own[k]
                if isinstance(t, Tensor):
                    t.set_value(_state_value(v))
                else:           # a torch child module's tensor
                    v = _state_value(v)
                    v = v._value if isinstance(v, Tensor) else v
                    with torch.no_grad():
                        t.copy_(torch.as_tensor(v).to(t.dtype))
            else:
                unexpected.append(k)
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # --------------------------------------------------------------- hooks
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a value it returns replaces the
        outputs. Returns a handle with ``remove()``."""
        return self.register_forward_hook(hook)

    # --------------------------------------------------------------- misc
    def clear_gradients(self, set_to_zero=False):
        for p in self.parameters():
            p.clear_gradient(set_to_zero)

    def full_name(self):
        return self._name_scope
