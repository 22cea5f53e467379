"""The paddle-style Tensor — the counterpart of ``paddle_tpu/tensor.py``.

A thin ``__slots__`` wrapper around a ``torch.Tensor`` in ``_value``, as the
JAX package's wraps a ``jax.Array``. It wraps and does not subclass: a
``torch.Tensor`` subclass could not give ``shape`` as a list or default
``stop_gradient`` to True without changing the torch code inside every
ported model. The compute methods are patched in by ``paddle_tpu_torch.ops``
when it is imported (``ops/patch_methods.py``), so an op is written once
and serves as function and method.

Autograd IS torch's: there is no tape here.

* ``stop_gradient`` is ``not _value.requires_grad`` (True by default, as in
  paddle; an op's output needs a gradient when an input does). Setting it
  True on a leaf turns ``requires_grad`` off; on an intermediate it rebinds
  ``_value`` to a detached tensor, which cuts the graph there as the JAX
  tape does. A tensor of a dtype torch cannot differentiate (integers,
  bool) keeps the flag itself and never takes part.
* ``.grad`` wraps ``_value.grad`` (leaves only, as in JAX); ``clear_grad``
  drops it; ``backward`` calls ``torch.autograd.backward``.
* In-place methods (``add_``, ``x[i] = v``, ...) compute out of place and
  rebind ``_value`` (``_assign``), so the graph runs on through the new
  value: torch would refuse an in-place write to a leaf that needs a
  gradient, and JAX keeps the tape linkage. Under ``no_grad`` (an
  optimizer's update) a leaf is written in its own storage instead, so it
  keeps its identity and its ``.grad``.
* ``numpy()`` of a bfloat16 tensor is float32: numpy has no bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework import device as _device
from .framework import dtype as _dtype_mod

__all__ = ["Tensor", "to_tensor"]


def _grad_dtype(d) -> bool:
    return d.is_floating_point or d.is_complex


class Tensor:
    __slots__ = ("_value", "_sg", "name", "persistable", "__weakref__")

    _iid = 0
    __array_priority__ = 100    # numpy scalars defer to the Tensor operators

    def __init__(self, value, stop_gradient: bool = True,
                 name: str | None = None):
        if isinstance(value, Tensor):
            value = value._value
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value)
        self._value = value
        self._sg = True
        if not stop_gradient:
            self.stop_gradient = False
        self.persistable = False
        if name is None:
            Tensor._iid += 1
            name = f"tensor_{Tensor._iid}"
        self.name = name

    # ------------------------------------------------------------ properties
    @property
    def value(self):
        return self._value

    @property
    def shape(self) -> list:
        return list(self._value.shape)

    @property
    def ndim(self) -> int:
        return self._value.dim()

    def dim(self) -> int:
        return self._value.dim()

    ndimension = dim

    @property
    def size(self) -> int:
        return int(self._value.numel())

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def place(self):
        return _device.Place(self._value.device)

    @property
    def is_leaf(self) -> bool:
        return self._value.is_leaf

    @property
    def stop_gradient(self) -> bool:
        if _grad_dtype(self._value.dtype):
            return not self._value.requires_grad
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, flag):
        flag = bool(flag)
        v = self._value
        if not _grad_dtype(v.dtype):
            self._sg = flag
        elif flag and v.requires_grad:
            if v.is_leaf:
                v.requires_grad_(False)
            else:       # an intermediate: cut the graph here
                self._value = v.detach()
        elif not flag and not v.requires_grad:
            if v.is_leaf:
                v.requires_grad_(True)
            else:       # a view made under no_grad: a leaf of its own
                self._value = v.detach().requires_grad_(True)

    @property
    def grad(self):
        v = self._value
        g = v.grad if v.is_leaf else None
        if g is None:
            return None
        return Tensor(g, name=self.name + "@GRAD")

    @grad.setter
    def grad(self, g):
        self._value.grad = None if g is None else _unwrap_like(g, self._value)

    def register_hook(self, hook):
        """``hook(grad)`` runs on each gradient flowing into this tensor; a
        returned Tensor replaces it. Returns a handle with ``remove()``."""
        def torch_hook(g):
            out = hook(Tensor(g))
            return None if out is None else _unwrap_like(out, g)

        return self._value.register_hook(torch_hook)

    # ------------------------------------------------------------ conversion
    def numpy(self) -> np.ndarray:
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._value.item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self._value.item())

    def __int__(self):
        return int(self._value.item())

    def __bool__(self):
        return bool(self._value.item())

    def __index__(self):
        return int(self._value.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __hash__(self):
        return id(self)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------------ autograd
    def backward(self, grad_tensor=None, retain_graph=False):
        from .autograd import backward

        backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self):
        self._value.grad = None

    def clear_gradient(self, set_to_zero: bool = False):
        if set_to_zero and self._value.grad is not None:
            self._value.grad.zero_()
        else:
            self._value.grad = None

    def detach(self) -> "Tensor":
        return Tensor(self._value.detach(), name=self.name + ".detach")

    def detach_(self) -> "Tensor":
        self._value = self._value.detach()
        return self

    def clone(self) -> "Tensor":
        from .ops import apply_op

        return apply_op(torch.clone, "clone", self)

    # ------------------------------------------------------------ in place
    def _assign(self, new_value):
        """In-place semantics: ``new_value`` (a torch tensor computed out
        of place) becomes this tensor's value. With grad on, the graph runs
        on through it. Under no_grad a leaf is written in its own storage
        when shape and dtype allow, so it keeps its identity and its
        ``.grad``; otherwise the new value is rebound and a leaf that
        needed a gradient still does."""
        old = self._value
        if torch.is_grad_enabled() and new_value.requires_grad:
            self._value = new_value
            return self
        if (old.is_leaf and new_value.shape == old.shape
                and new_value.dtype == old.dtype
                and new_value.device == old.device
                and not torch.is_grad_enabled()):
            with torch.no_grad():
                old.copy_(new_value)
            return self
        new = new_value.detach()
        if old.requires_grad and _grad_dtype(new.dtype):
            new.requires_grad_(True)
            g = old.grad if old.is_leaf else None
            if g is not None and g.shape == new.shape and g.dtype == new.dtype:
                new.grad = g
        self._value = new
        return self

    def copy_(self, other, blocking=True):
        src = _unwrap_like(other, self._value)
        return self._assign(src.to(self._value.dtype)
                            .broadcast_to(self._value.shape).clone())

    def set_value(self, value):
        src = _unwrap_like(value, self._value)
        with torch.no_grad():
            return self._assign(src.to(self._value.dtype)
                                .reshape(self._value.shape).clone())

    def get_tensor(self):
        return self

    # ------------------------------------------------------------ devices
    def pin_memory(self):
        return self

    def cpu(self):
        from .ops import apply_op

        return apply_op(lambda v: v.cpu(), "cpu", self)

    def cuda(self, device_id=0, blocking=True):
        from .ops import apply_op

        dev = _device.resolve_device(f"cuda:{int(device_id or 0)}")
        return apply_op(lambda v: v.to(dev), "cuda", self)

    def to(self, *args, **kwargs):
        dtype = kwargs.get("dtype")
        device = kwargs.get("device")
        for a in args:
            if isinstance(a, str) and a.lower() in _dtype_mod._STR_ALIASES:
                dtype = a
            elif isinstance(a, (str, _device.Place, torch.device)):
                device = a
            else:
                dtype = a
        out = self
        if dtype is not None:
            out = out.astype(dtype)
        if device is not None:
            from .ops import apply_op

            dev = _resolve_place(device)
            out = apply_op(lambda v: v.to(dev), "to", out)
        return out

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, "
                f"dtype={_dtype_mod.dtype_to_str(self.dtype)}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {self.numpy()})")

    __str__ = __repr__


def _unwrap_like(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (Tensor, torch tensor, array or scalar) as a torch tensor on
    ``like``'s device."""
    if isinstance(x, Tensor):
        x = x._value
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(like.device)


def _resolve_place(place) -> torch.device:
    """A place argument (None: the current place; a Place; "cpu", "gpu:0",
    "cuda:0"; a torch.device) as a ``torch.device``."""
    if place is None:
        return _device.get_place().device
    if isinstance(place, _device.Place):
        return place.device
    if isinstance(place, torch.device):
        return _device.resolve_device(place)
    name = str(place)
    if name.startswith("gpu"):
        name = "cuda" + name[3:]
    return _device.resolve_device(name)


def _contains_ndarray(seq):
    for x in seq:
        if isinstance(x, np.ndarray):
            return True
        if isinstance(x, (list, tuple)) and _contains_ndarray(x):
            return True
    return False


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor`` on ``place`` (None: the current place, which is
    the card unless ``set_device("cpu")`` was called; without CUDA that
    raises unless the CPU was asked for).

    Dtypes follow the JAX package (x64 on): Python floats and lists of
    floats take the default dtype (float32), numpy arrays keep theirs
    (float64 stays float64), Python ints give int64. A Tensor or torch
    tensor is copied into a new leaf (its graph is not followed)."""
    dtype = _dtype_mod.convert_dtype(dtype)
    dev = _resolve_place(place)
    if isinstance(data, Tensor):
        data = data._value
    if isinstance(data, torch.Tensor):     # a copy, as paddle makes
        v = data.detach().to(dev, dtype or data.dtype, copy=True)
        return Tensor(v, stop_gradient=stop_gradient)
    arr = np.asarray(data)
    if dtype is None and arr.dtype == np.float64 and not (
            isinstance(data, np.ndarray) or (isinstance(data, (list, tuple))
                                             and _contains_ndarray(data))):
        dtype = _dtype_mod.get_default_dtype()   # Python floats
    if arr.dtype.kind == "U" or arr.dtype == object:
        raise TypeError(f"to_tensor: cannot make a tensor of {arr.dtype}")
    v = torch.tensor(np.array(arr, order="C"), device=dev)   # keeps 0-d
    if dtype is not None and v.dtype != dtype:
        v = v.to(dtype)
    return Tensor(v, stop_gradient=stop_gradient)


def tensor_seam(fn):
    """A torch-level function made to accept the paddle-style Tensor at its
    public seam: Tensor arguments are unwrapped (their graph is torch's, so
    gradients reach them with no extra code), and when any argument was a
    Tensor the torch tensors it returns come back wrapped. Called with
    torch tensors only, it is ``fn``."""
    import functools

    def wrap(o):
        if isinstance(o, torch.Tensor):
            return Tensor(o)
        if isinstance(o, (tuple, list)):
            return type(o)(wrap(e) for e in o)
        return o

    @functools.wraps(fn)
    def seam(*args, **kwargs):
        wrapped = any(isinstance(a, Tensor) for a in args) or any(
            isinstance(a, Tensor) for a in kwargs.values())
        if not wrapped:
            return fn(*args, **kwargs)
        out = fn(*[a._value if isinstance(a, Tensor) else a for a in args],
                 **{k: v._value if isinstance(v, Tensor) else v
                    for k, v in kwargs.items()})
        return wrap(out)

    return seam
