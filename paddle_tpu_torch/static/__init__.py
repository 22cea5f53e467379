"""paddle.static — the counterpart of ``paddle_tpu/static/__init__.py``,
as far as the port has one: ``InputSpec``, the shape contract
``jit.to_static`` and ``jit.save`` take (``None`` dims are dynamic).
There is no Program IR here, as in JAX."""
from __future__ import annotations

from ..framework.dtype import convert_dtype

__all__ = ["InputSpec"]


class InputSpec:
    """Reference: python/paddle/static/input.py:44. ``dtype`` is a torch
    dtype (the port's dtypes are torch's)."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = convert_dtype(str(dtype).replace("paddle.", "")
                                   if isinstance(dtype, str) else dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tuple(tensor.shape), tensor.dtype,
                   name or getattr(tensor, "name", None))

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, ndarray.dtype, name)

    def batch(self, batch_size):
        return InputSpec((batch_size,) + self.shape, self.dtype, self.name)

    def unbatch(self):
        return InputSpec(self.shape[1:], self.dtype, self.name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")
