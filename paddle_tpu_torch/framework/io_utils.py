"""paddle.save / paddle.load — the counterpart of
``paddle_tpu/framework/io_utils.py``. Reference: python/paddle/framework/
io.py (pickle-based).

A file is a pickle of ``{"__paddle_tpu_save_format__": 1, "obj": ...}``
in which every Tensor (the port's ``Tensor``, or a bare ``torch.Tensor``)
travels as a ``_TensorPayload`` (a numpy array and ``stop_gradient``), as
the JAX package writes it. The two packages read each other's files:

* the payload class is pickled under the JAX package's name,
  ``paddle_tpu.framework.io_utils._TensorPayload``: ``_Pickler`` writes
  that name itself (pickle would import the module to check it, and the
  port never imports the JAX package), and ``_Unpickler`` maps it back to
  this module's class;
* bfloat16, which numpy has not, travels as the JAX package keeps it: a
  numpy array of ``ml_dtypes.bfloat16``. The port writes the bits as
  uint16 with ``numpy.ndarray.view(bits, ml_dtypes.bfloat16)`` as the
  array's constructor, by name, so the reader needs ``ml_dtypes`` and the
  writer does not; it reads such an array back as a torch bfloat16 tensor
  without importing ``ml_dtypes`` (``_Unpickler`` stands in for the dtype
  and recognises the arrays built with it).

``load`` gives Tensors on the current place (``framework.device``), as
JAX's gives them on its default device. ``save`` writes a temp file in the
target directory, fsyncs it, ``os.replace``s it over the target and fsyncs
the directory, so a preemption mid-save never leaves a truncated file
where a good one was. A marker-less file whose values all have a
reference PaddlePaddle reduce shape (``.pdparams`` / ``.pdopt``: eager
tensors as ``(name, ndarray)``, dense tensors as bare arrays) loads as
Tensors (``_from_reference_format``).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..tensor import Tensor, to_tensor

__all__ = ["save", "load", "fsync_file", "fsync_dir"]

# top-level wrapper key identifying a file written by save() (either
# package's): loading a marked file never consults the reference heuristics
_FORMAT_KEY = "__paddle_tpu_save_format__"
_FORMAT_VERSION = 1
_PAYLOAD_NAME = ("paddle_tpu.framework.io_utils", "_TensorPayload")


class _TensorPayload:
    def __init__(self, array, stop_gradient):
        self.array = array
        self.stop_gradient = stop_gradient


class _GlobalRef:
    """A global ``module.qualname`` written by name, never imported."""

    def __init__(self, module, qualname):
        self.module, self.qualname = module, qualname

    def __call__(self, *args):      # pickle reduces only with callables
        raise TypeError(f"{self.module}.{self.qualname} is written by name "
                        "into a pickle, not called")


_NDARRAY_VIEW = _GlobalRef("numpy", "ndarray.view")
_ML_BFLOAT16 = _GlobalRef("ml_dtypes", "bfloat16")


class _BF16Bits:
    """A bfloat16 array's bits (uint16), pickled as
    ``numpy.ndarray.view(bits, ml_dtypes.bfloat16)``."""

    def __init__(self, bits):
        self.bits = bits


class _Pickler(pickle._Pickler):
    """pickle's Python pickler, writing ``_GlobalRef``s and the payload
    class under the names the JAX package reads."""

    def reducer_override(self, obj):
        if isinstance(obj, _GlobalRef):
            return obj.qualname             # -> save_global(obj, name)
        if isinstance(obj, _BF16Bits):
            return _NDARRAY_VIEW, (obj.bits, _ML_BFLOAT16)
        return NotImplemented

    def save_global(self, obj, name=None):
        if isinstance(obj, _GlobalRef):
            module, qualname = obj.module, obj.qualname
        elif obj is _TensorPayload:
            module, qualname = _PAYLOAD_NAME
        else:
            return super().save_global(obj, name)
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _BF16Marker:
    """Stands in for ``ml_dtypes.bfloat16`` while reading."""


def _view(arr, dtype):
    """``numpy.ndarray.view`` as the reader meets it: the port's bfloat16
    arrays come back as their bits (``_BF16Bits``)."""
    if dtype is _BF16Marker:
        return _BF16Bits(arr)
    return arr.view(dtype)


class _Unpickler(pickle.Unpickler):
    """Maps the JAX package's payload class to this module's and reads
    ``ml_dtypes.bfloat16`` arrays (the JAX package's: 2-byte void arrays
    whose dtype object it remembers in ``bf16_dtypes``; the port's: their
    bits) without ``ml_dtypes``; ``_unpack`` turns both into torch
    bfloat16 tensors."""

    def __init__(self, f):
        super().__init__(f)
        self.bf16_dtypes = []

    def _dtype(self, obj, align=False, copy=False):
        if obj is _BF16Marker:
            d = np.dtype("V2")
            self.bf16_dtypes.append(d)
            return d
        return np.dtype(obj, align, copy)

    def find_class(self, module, name):
        if (module, name) == _PAYLOAD_NAME:
            return _TensorPayload
        if module == "ml_dtypes" and name == "bfloat16":
            return _BF16Marker
        if module == "numpy" and name == "dtype":
            return self._dtype
        if module == "numpy" and name == "ndarray.view":
            return _view
        return super().find_class(module, name)


def _payload(t, stop_gradient):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return _TensorPayload(_BF16Bits(t.contiguous().view(torch.int16)
                                        .numpy().view(np.uint16)),
                              stop_gradient)
    return _TensorPayload(np.ascontiguousarray(t.numpy()), stop_gradient)


def _pack(obj):
    if isinstance(obj, Tensor):
        return _payload(obj._value, obj.stop_gradient)
    if isinstance(obj, torch.Tensor):
        return _payload(obj, not obj.requires_grad)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_pack(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_pack(v) for v in obj)
    return obj


def _array(arr, bf16):
    """A loaded array: a torch bfloat16 tensor (CPU) when its dtype is one
    of the ``bf16`` stand-ins, else the array."""
    if isinstance(arr, _BF16Bits):
        arr = arr.bits
    elif not (isinstance(arr, np.ndarray)
              and any(arr.dtype is d for d in bf16)):
        return arr
    bits = np.ascontiguousarray(arr).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _tensor(arr, bf16, stop_gradient=True):
    return to_tensor(_array(arr, bf16), stop_gradient=stop_gradient)


def _unpack(obj, bf16):
    if isinstance(obj, _TensorPayload):
        return _tensor(obj.array, bf16, obj.stop_gradient)
    if isinstance(obj, (np.ndarray, _BF16Bits)):
        a = _array(obj, bf16)       # a bare bfloat16 array: f32, exact
        return a.float().numpy() if isinstance(a, torch.Tensor) else a
    if isinstance(obj, dict):
        return {k: _unpack(v, bf16) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, bf16) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, bf16) for v in obj)
    return obj


def fsync_file(f):
    """flush + fsync a file object; best-effort on filesystems without it."""
    f.flush()
    try:
        os.fsync(f.fileno())
    except OSError:  # pragma: no cover - exotic fs
        pass


def fsync_dir(path):
    """fsync a DIRECTORY so a rename into it survives power loss (POSIX:
    replace() orders the entry, the dir fsync makes it durable)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - e.g. non-POSIX
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def dump(obj, f, protocol=4):
    """Pickle ``obj`` (already packed) into ``f`` with ``_Pickler``."""
    _Pickler(f, protocol=protocol).dump(obj)


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (Tensors, torch tensors, nested dicts / lists /
    tuples, numpy arrays, Python values) to ``path``, crash-safely."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # temp file IN the target directory: os.replace must not cross devices,
    # and a same-dir rename is atomic on POSIX
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            dump({_FORMAT_KEY: _FORMAT_VERSION, "obj": _pack(obj)}, f,
                 protocol)
            fsync_file(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    fsync_dir(d or ".")


def _from_reference_format(obj, bf16):
    """Values of a REAL PaddlePaddle checkpoint (.pdparams / .pdopt) as
    Tensors: eager tensors reduce to ``(name, ndarray)`` and dense tensors
    to bare arrays (reference io.py:413), both readable without paddle."""
    if (isinstance(obj, tuple) and len(obj) == 2
            and isinstance(obj[0], str) and isinstance(obj[1], np.ndarray)):
        return _tensor(obj[1], bf16)
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        return _tensor(obj, bf16)
    if isinstance(obj, dict):
        return {k: _from_reference_format(v, bf16) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_reference_format(v, bf16) for v in obj]
    return obj


def _looks_like_reference_ckpt(obj):
    """True when EVERY value has a reference reduce shape and none is a
    payload. Only consulted for files without the format marker."""
    if not isinstance(obj, dict):
        return False
    vals = list(obj.values())
    if not vals or any(isinstance(v, _TensorPayload) for v in vals):
        return False

    def _is_eager_tuple(v):
        return (isinstance(v, tuple) and len(v) == 2
                and isinstance(v[0], str) and isinstance(v[1], np.ndarray))

    return all(_is_eager_tuple(v)
               or (isinstance(v, np.ndarray) and v.dtype != object)
               for v in vals)


def load(path, **configs):
    """The object ``save`` wrote (Tensors on the current place), or a
    reference checkpoint's values as Tensors."""
    with open(path, "rb") as f:
        reader = _Unpickler(f)
        obj, bf16 = reader.load(), reader.bf16_dtypes
    if isinstance(obj, dict) and obj.get(_FORMAT_KEY) is not None:
        return _unpack(obj["obj"], bf16)
    if _looks_like_reference_ckpt(obj):
        return _from_reference_format(obj, bf16)
    return _unpack(obj, bf16)
