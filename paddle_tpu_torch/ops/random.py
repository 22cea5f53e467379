"""Random ops — the counterpart of ``paddle_tpu/ops/random.py``.

Every draw comes from the port's default generator of the device it lands
on (``framework.random.default_generator``: one per device, reseeded by
``paddle.seed``), never from torch's global generator, as the JAX package
draws its keys from its own default generator. The two frameworks give
different numbers from one seed: tests hold these ops to distribution
pins and to repeatability under ``seed``.
"""
from __future__ import annotations

import torch

from ..framework import dtype as _dt
from ..framework import random as _rng
from ..tensor import Tensor
from . import _place

__all__ = [
    "uniform", "uniform_", "normal", "normal_", "standard_normal", "randn",
    "rand", "randint", "randint_like", "randperm", "multinomial",
    "bernoulli", "poisson", "exponential_", "binomial", "standard_gamma",
    "log_normal", "cauchy_", "geometric_",
]


def _gen(device, seed=0):
    return (_rng.make_generator(seed, device) if seed
            else _rng.default_generator(device))


def _shape(shape):
    return [int(s.item()) if isinstance(s, Tensor) else int(s)
            for s in shape]


def _float(dtype):
    return _dt.convert_dtype(dtype) or _dt.get_default_dtype()


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = _place()
    u = torch.rand(_shape(shape), generator=_gen(dev, seed), device=dev,
                   dtype=_float(dtype))
    return Tensor(u * (max - min) + min)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    v = x._value
    u = torch.rand(v.shape, generator=_gen(v.device, seed), device=v.device,
                   dtype=v.dtype)
    return x._assign(u * (max - min) + min)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        ref = mean if isinstance(mean, Tensor) else std
        dev = ref._value.device
        m = (mean._value if isinstance(mean, Tensor)
             else torch.tensor(mean, dtype=_dt.get_default_dtype()))
        s = (std._value if isinstance(std, Tensor)
             else torch.tensor(std, dtype=_dt.get_default_dtype()))
        d = torch.promote_types(m.dtype, s.dtype)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, generator=_gen(dev), device=dev, dtype=d)
        return Tensor(m.to(dev, d) + s.to(dev, d) * z)
    dev = _place()
    z = torch.randn(_shape(shape or [1]), generator=_gen(dev), device=dev,
                    dtype=_dt.get_default_dtype())
    return Tensor(mean + std * z)


def normal_(x, mean=0.0, std=1.0, name=None):
    v = x._value
    z = torch.randn(v.shape, generator=_gen(v.device), device=v.device,
                    dtype=v.dtype)
    return x._assign(mean + std * z)


def standard_normal(shape, dtype=None, name=None):
    dev = _place()
    return Tensor(torch.randn(_shape(shape), generator=_gen(dev), device=dev,
                              dtype=_float(dtype)))


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, min=0.0, max=1.0)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = _place()
    return Tensor(torch.randint(int(low), int(high), _shape(shape),
                                generator=_gen(dev), device=dev,
                                dtype=_dt.convert_dtype(dtype)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    v = x._value
    return Tensor(torch.randint(int(low), int(high), v.shape,
                                generator=_gen(v.device), device=v.device,
                                dtype=_dt.convert_dtype(dtype) or v.dtype))


def randperm(n, dtype="int64", name=None):
    dev = _place()
    return Tensor(torch.randperm(int(n), generator=_gen(dev), device=dev,
                                 dtype=_dt.convert_dtype(dtype)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    v = x._value
    return Tensor(torch.multinomial(v.float(), num_samples, replacement,
                                    generator=_gen(v.device)))


def bernoulli(x, name=None):
    v = x._value
    u = torch.rand(v.shape, generator=_gen(v.device), device=v.device)
    return Tensor((u < v.float()).to(v.dtype))


def poisson(x, name=None):
    v = x._value
    return Tensor(torch.poisson(v.float(), generator=_gen(v.device))
                  .to(v.dtype))


def binomial(count, prob, name=None):
    c = count._value if isinstance(count, Tensor) else torch.as_tensor(count)
    p = prob._value if isinstance(prob, Tensor) else torch.as_tensor(prob)
    c, p = torch.broadcast_tensors(c.float(), p.float().to(c.device))
    return Tensor(torch.binomial(c, p, generator=_gen(c.device))
                  .to(torch.int64))


def standard_gamma(x, name=None):
    v = x._value
    return Tensor(torch._standard_gamma(v, generator=_gen(v.device)))


def exponential_(x, lam=1.0, name=None):
    v = x._value
    out = torch.empty_like(v).exponential_(lam, generator=_gen(v.device))
    return x._assign(out)


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    dev = _place()
    z = torch.randn(_shape(shape or [1]), generator=_gen(dev), device=dev,
                    dtype=_dt.get_default_dtype())
    return Tensor(torch.exp(mean + std * z))


def cauchy_(x, loc=0, scale=1, name=None):
    v = x._value
    return x._assign(torch.empty_like(v).cauchy_(loc, scale,
                                                 generator=_gen(v.device)))


def geometric_(x, probs, name=None):
    v = x._value
    p = torch.as_tensor(probs._value if isinstance(probs, Tensor) else probs,
                        dtype=torch.float32, device=v.device)
    u = torch.rand(v.shape, generator=_gen(v.device), device=v.device)
    return x._assign(torch.ceil(torch.log1p(-u) / torch.log1p(-p))
                     .to(v.dtype))
