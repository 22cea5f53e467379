"""Optimizers — the counterpart of ``paddle_tpu/optimizer/__init__.py``
(``Optimizer`` :37-128, ``Adam`` :230-265, ``AdamW`` :268-303).

Accumulators (moments) are kept per parameter, created as zeros in the
parameter's dtype at first use. The update rule ``_update`` is shared by two
callers, as in the JAX package:

* ``Optimizer.step`` (eager): with ``multi_precision`` a low-precision
  parameter is updated through an f32 master copy with f32 gradients, and
  the scalars are Python floats;
* ``jit.TrainStep``: every parameter is updated in its own dtype
  (``jit/train.py:201-212``), with the learning rate and the step counter as
  f32 / int32 tensors. A tensor scalar promotes a bf16 operand to f32 where
  it meets it, as a strong f32 scalar does in JAX; Python floats do not.

Learning-rate schedulers (``lr.py``) are not ported yet: the learning rate
is a float.
"""
from __future__ import annotations

import numbers

import torch

__all__ = ["Optimizer", "Adam", "AdamW"]


def _pow_step(base, t):
    """``base ** t``: an f32 pow when the step counter is a tensor (the
    TrainStep's, traced in JAX), exact Python-float math for a Python int
    (the eager step) — JAX ``_pow_step`` :26-36."""
    if isinstance(t, torch.Tensor):
        return torch.pow(torch.tensor(base, dtype=torch.float32,
                                      device=t.device), t.float())
    return base ** t


def _promoted(x, *scalars):
    """x in the dtype its tensor scalars promote it to (JAX's rule for a
    strong scalar); Python floats leave it as it is."""
    dt = x.dtype
    for s in scalars:
        if isinstance(s, torch.Tensor):
            dt = torch.promote_types(dt, s.dtype)
    return x.to(dt)


class Optimizer:
    """``parameters``: tensors, or (name, tensor) pairs such as
    ``model.named_parameters()``; names are what
    ``apply_decay_param_fun`` sees (unnamed parameters are ``param_<i>``)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._params, self._names = [], {}
        for i, item in enumerate(parameters):
            name, p = item if isinstance(item, tuple) else (f"param_{i}",
                                                            item)
            self._params.append(p)
            self._names[id(p)] = name
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: dict = {}
        self._master_weights: dict = {}
        self._step_count = 0

    # ------------------------------------------------------------ lr
    def get_lr(self) -> float:
        if not isinstance(self._learning_rate, numbers.Real):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet; pass a float")
        return float(self._learning_rate)

    def _param_name(self, p):
        return self._names.get(id(p), "")

    # --------------------------------------------------- accumulators
    def _acc(self, name, p):
        store = self._accumulators.setdefault(name, {})
        if id(p) not in store:
            store[id(p)] = torch.zeros_like(p)
        return store[id(p)]

    def _set_acc(self, name, p, value):
        self._accumulators[name][id(p)] = value

    # ------------------------------------------------------- main api
    @torch.no_grad()
    def step(self):
        """One eager update of every parameter that has a gradient."""
        params_grads = [(p, p.grad) for p in self._params
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        for p, g in params_grads:
            if g is None:
                continue
            lr = self.get_lr()
            gval = g.float() if self._multi_precision else g
            if (self._multi_precision and p.is_floating_point()
                    and p.dtype != torch.float32):
                master = self._master_weights.get(id(p))
                if master is None:
                    master = p.detach().float()
                master = self._update(p, master, gval, lr, self._step_count)
                self._master_weights[id(p)] = master
                p.copy_(master.to(p.dtype))
            else:
                p.copy_(self._update(p, p.detach(), gval.to(p.dtype), lr,
                                     self._step_count).to(p.dtype))

    def _update(self, p, pval, g, lr, step):
        """The new value of ``pval`` (functional: nothing is written in
        place) after one step with gradient ``g``."""
        raise NotImplementedError

    def _apply_decay(self, pval, g):
        """L2 regularisation folded into the gradient (paddle's
        weight_decay for optimizers other than AdamW)."""
        wd = self._weight_decay
        if isinstance(wd, numbers.Real) and wd != 0.0:
            return g + wd * pval
        if wd not in (None, 0.0):
            raise NotImplementedError("regularizer objects are not ported")
        return g

    def clear_grad(self, set_to_zero=False):
        for p in self._params:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._amsgrad = amsgrad

    def _moments(self, p, g, step):
        """(mhat, vhat): the bias-corrected moments, the stored ones updated
        in g's dtype."""
        b1, b2 = self._beta1, self._beta2
        b1p, b2p = _pow_step(b1, step), _pow_step(b2, step)
        m = b1 * self._acc("moment1", p) + (1 - b1) * g
        v = b2 * self._acc("moment2", p) + (1 - b2) * torch.square(g)
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        if self._amsgrad:
            v = torch.maximum(self._acc("moment2_max", p), v)
            self._set_acc("moment2_max", p, v)
        return (_promoted(m, b1p) / (1 - b1p), _promoted(v, b2p) / (1 - b2p))

    def _update(self, p, pval, g, lr, step):
        g = self._apply_decay(pval, g)
        mhat, vhat = self._moments(p, g, step)
        return _promoted(pval, lr) - lr * mhat / (torch.sqrt(vhat) + self._eps)


class AdamW(Adam):
    """Decoupled weight decay: p * (1 - lr * decay) before the Adam step;
    ``lr_ratio(p)`` scales the learning rate per parameter and
    ``apply_decay_param_fun(name)`` False exempts a parameter from decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        if not isinstance(weight_decay, numbers.Real):
            raise NotImplementedError("regularizer objects are not ported")
        self._wd_coeff = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update(self, p, pval, g, lr, step):
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        decay = self._wd_coeff
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(self._param_name(p))):
            decay = 0.0
        mhat, vhat = self._moments(p, g, step)
        pnew = _promoted(pval, lr) * (1.0 - lr * decay)
        return pnew - lr * mhat / (torch.sqrt(vhat) + self._eps)
