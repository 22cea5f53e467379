"""Weight initializers — the counterpart of
``paddle_tpu/nn/initializer/__init__.py``.

An initializer is a callable ``init(shape, dtype=None, device=None,
generator=None)`` returning a new torch tensor on ``device`` (None: the
current place). Random ones draw in float32 from ``generator``, by default
the port's default generator of the device
(``framework.default_generator``; JAX draws ``next_key()`` from its own),
and cast to ``dtype`` (None: the default dtype). The draws cannot equal
``jax.random``'s: the tests hold them to their distributions (moments,
truncation bounds, fans, orthogonality) and carry weights across by
``set_state_dict``.

Fans follow paddle's layouts (JAX ``_fans``): a 2-d weight is [in, out]
(``Linear``), a conv kernel [out, in, *k].
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...framework import dtype as _dt
from ...framework.random import default_generator

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Dirac", "Orthogonal", "Bilinear", "calculate_gain",
           "set_global_initializer", "get_global_initializer",
           "ConstantInitializer", "NormalInitializer", "UniformInitializer",
           "XavierInitializer", "MSRAInitializer", "NumpyArrayInitializer"]


def _device(device) -> torch.device:
    if device is None:
        from ...framework.device import get_place

        return get_place().device
    return torch.device(device)


def _dtype(dtype):
    return _dt.convert_dtype(dtype) or _dt.get_default_dtype()


class Initializer:
    def __call__(self, shape, dtype=None, device=None, generator=None):
        raise NotImplementedError

    @staticmethod
    def _gen(device, generator):
        return generator if generator is not None else default_generator(
            device)

    def _normal(self, shape, device, generator):
        dev = _device(device)
        return torch.randn(list(shape), dtype=torch.float32, device=dev,
                           generator=self._gen(dev, generator))

    def _uniform(self, shape, low, high, device, generator):
        dev = _device(device)
        u = torch.empty(list(shape), dtype=torch.float32, device=dev)
        return u.uniform_(low, high, generator=self._gen(dev, generator))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return torch.full(list(shape), self.value, dtype=_dtype(dtype),
                          device=_device(device))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None, generator=None):
        d = _dtype(dtype)
        if not d.is_floating_point:
            d = torch.float32
        z = self._normal(shape, device, generator)
        return (self.mean + self.std * z).to(d)


class TruncatedNormal(Initializer):
    """mean + std * z, z standard normal truncated to [a, b]."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=None, device=None, generator=None):
        dev = _device(device)
        z = torch.empty(list(shape), dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, self.a, self.b,
                                    generator=self._gen(dev, generator))
        return (self.mean + self.std * z).to(_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return self._uniform(shape, self.low, self.high, device,
                             generator).to(_dtype(dtype))


def _fans(shape):
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:            # paddle's Linear weight: [in, out]
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))    # conv kernel [out, in, *k]
    return shape[1] * receptive, shape[0] * receptive


class _Fanned(Initializer):
    def _fans(self, shape):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo_given = getattr(self, "fan_out", None)
        return fi, fo if fo_given is None else fo_given


class XavierNormal(_Fanned):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = self._fans(shape)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (std * self._normal(shape, device, generator)).to(
            _dtype(dtype))


class XavierUniform(_Fanned):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = self._fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return self._uniform(shape, -limit, limit, device, generator).to(
            _dtype(dtype))


class _Kaiming(_Fanned):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return math.sqrt(2.0)


class KaimingNormal(_Kaiming):
    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, _ = self._fans(shape)
        std = self._gain() / math.sqrt(fi)
        return (std * self._normal(shape, device, generator)).to(
            _dtype(dtype))


class KaimingUniform(_Kaiming):
    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, _ = self._fans(shape)
        limit = self._gain() * math.sqrt(3.0 / fi)
        return self._uniform(shape, -limit, limit, device, generator).to(
            _dtype(dtype))


class Assign(Initializer):
    """The given values (a Tensor, torch tensor, array or list), reshaped to
    ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        v = self.value
        if hasattr(v, "_value"):
            v = v._value
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        return v.detach().to(_device(device), _dtype(dtype)).reshape(
            list(shape)).clone()


class Dirac(Initializer):
    """A conv kernel [out, in, *k] that passes channel i of each group
    through at the kernel's centre."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=None, device=None, generator=None):
        out = np.zeros(shape, dtype=np.float32)
        oc, ic = shape[0], shape[1]
        mid = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                out[(g * (oc // self.groups) + i, i, *mid)] = 1.0
        return torch.from_numpy(out).to(_device(device), _dtype(dtype))


class Orthogonal(Initializer):
    """gain * Q of a normal draw's QR (rows of the [shape[0], prod(rest)]
    matrix orthonormal when they are the fewer, else its columns), with R's
    diagonal signs folded in."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        flat = self._normal((max(rows, cols), min(rows, cols)), device,
                            generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(list(shape)).to(
            _dtype(dtype))


class Bilinear(Initializer):
    """The bilinear-upsampling kernel for a transposed conv's weight
    [C_out, C_in, K, K]: the filter on each (i, i) pair."""

    def __call__(self, shape, dtype=None, device=None, generator=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 4:
            raise ValueError(f"Bilinear expects a 4-D conv weight, got "
                             f"{shape}")
        k = shape[-1]
        factor = (k + 1) // 2
        center = factor - 1.0 if k % 2 == 1 else factor - 0.5
        og = np.ogrid[:k, :k]
        filt = ((1 - np.abs(og[0] - center) / factor)
                * (1 - np.abs(og[1] - center) / factor))
        w = np.zeros(shape, np.float32)
        for i in range(min(shape[0], shape[1])):
            w[i, i] = filt
        return torch.from_numpy(w).to(_device(device), _dtype(dtype))


# paddle's legacy names
ConstantInitializer = Constant
NormalInitializer = Normal
UniformInitializer = Uniform
XavierInitializer = XavierUniform
MSRAInitializer = KaimingNormal
NumpyArrayInitializer = Assign


def calculate_gain(nonlinearity, param=None):
    recommended = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in recommended:
        raise ValueError(f"unsupported nonlinearity {nonlinearity}")
    return recommended[nonlinearity]


_global_initializer = {"value": None}


def set_global_initializer(weight_init, bias_init=None):
    """The initializers of parameters created from now on without one of
    their own (weights, biases); ``set_global_initializer(None)`` resets."""
    _global_initializer["value"] = (weight_init, bias_init)


def get_global_initializer():
    return _global_initializer["value"]
