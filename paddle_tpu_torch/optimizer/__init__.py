"""Optimizers — the counterpart of ``paddle_tpu/optimizer/__init__.py``
(``Optimizer`` :39-194, ``SGD`` :196-206, ``Momentum`` :209-227, ``Adam``
:230-265, ``AdamW`` :268-303) and of its learning-rate schedulers
(``lr.py``).

Accumulators (moments, velocities) are kept per parameter, created as zeros
in the parameter's dtype at first use or, under
``jit.TrainStep``, before the step's first run (``_acc_names``). A stored
accumulator is overwritten IN PLACE when the new value has its dtype and
shape (``_set_acc``), so a captured step writes the tensors it read; a
value of another dtype (an f32 moment over a bf16 parameter, from the eager
``multi_precision`` path) replaces it. The update rule ``_update`` is shared
by two callers, as in the JAX package:

* ``Optimizer.step`` (eager): with ``multi_precision`` a low-precision
  parameter is updated through an f32 master copy with f32 gradients, and
  the learning rate and step counter are Python numbers;
* ``jit.TrainStep``: every parameter is updated in its own dtype
  (``jit/train.py:201-212``), with the learning rate and the step counter
  as f32 / int32 device tensors. A tensor scalar promotes a low-precision
  operand to f32 where it meets it (``_promoted``), as a strong f32 scalar
  does in JAX; Python floats do not.

The learning rate is a float or an ``lr.LRScheduler``; ``get_lr`` reads the
scheduler's current rate and the caller steps it.
"""
from __future__ import annotations

import numbers

import torch

from . import lr
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr"]


def _pow_step(base, t):
    """``base ** t``: an f32 pow when the step counter is a tensor (the
    TrainStep's, traced in JAX; the base is made on the device, so a CUDA
    graph can hold the pow), exact Python-float math for a Python int (the
    eager step) — JAX ``_pow_step`` :26-36."""
    if isinstance(t, torch.Tensor):
        return torch.pow(torch.full((), base, dtype=torch.float32,
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


def _named(items, start):
    """[(name, tensor)] of tensors or (name, tensor) pairs; unnamed tensors
    are ``param_<i>`` counting from ``start``."""
    out = []
    for i, item in enumerate(items, start):
        out.append(item if isinstance(item, tuple) else (f"param_{i}", item))
    return out


class Optimizer:
    """``parameters``: tensors, (name, tensor) pairs such as
    ``model.named_parameters()``, or parameter groups — dicts whose
    ``"params"`` holds either (JAX :44-53; a group's other keys are kept and
    not read, as there). Names are what ``apply_decay_param_fun`` sees and
    what ``state_dict`` keys start with (unnamed parameters are
    ``param_<i>``)."""

    _acc_names: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        items = list(parameters)
        if items and isinstance(items[0], dict):
            groups = [dict(g) for g in items]
        else:
            groups = [{"params": items}]
        self._param_groups, self._params, self._names = [], [], {}
        for g in groups:
            named = _named(g["params"], len(self._params))
            g["params"] = [p for _, p in named]
            self._param_groups.append(g)
            for pname, p in named:
                self._params.append(p)
                self._names[id(p)] = pname
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: dict = {}
        self._master_weights: dict = {}
        self._step_count = 0

    # ------------------------------------------------------------ lr
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        if not isinstance(self._learning_rate, numbers.Real):
            raise TypeError("learning_rate must be a float or an "
                            f"LRScheduler, got {type(self._learning_rate)}")
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = value

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def _param_name(self, p):
        return self._names.get(id(p), "")

    # --------------------------------------------------- accumulators
    def _acc(self, name, p):
        store = self._accumulators.setdefault(name, {})
        if id(p) not in store:
            store[id(p)] = torch.zeros_like(p.detach())
        return store[id(p)]

    def _set_acc(self, name, p, value):
        """Store ``value``: into the stored tensor when it has value's dtype
        and shape (in place), else in its stead."""
        store = self._accumulators.setdefault(name, {})
        cur = store.get(id(p))
        if (cur is not None and cur is not value and cur.dtype == value.dtype
                and cur.shape == value.shape):
            cur.copy_(value)
        else:
            store[id(p)] = value

    def _materialize_accumulators(self, params):
        """Create every accumulator the update reads for ``params`` (JAX
        ``TrainStep._gather_acc_state`` :370-398), so a captured step reads
        and writes tensors that outlive it."""
        for name in self._acc_names:
            if name == "moment2_max" and not getattr(self, "_amsgrad", False):
                continue
            for p in params:
                self._acc(name, p)

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
        """The new value of ``pval`` after one step with gradient ``g``
        (accumulators are stored through ``_set_acc``)."""
        raise NotImplementedError

    def _apply_decay(self, pval, g):
        """L2 regularisation folded into the gradient (paddle's
        weight_decay for optimizers other than AdamW), the coefficient
        rounded to g's dtype first (JAX :133-146)."""
        wd = self._weight_decay
        if isinstance(wd, numbers.Real) and wd != 0.0:
            wd = float(torch.tensor(wd, dtype=g.dtype, device="cpu"))
            return g + wd * pval
        if wd not in (None, 0.0):
            raise NotImplementedError("regularizer objects are not ported")
        return g

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()``; returns (None, [(param,
        grad)]) as JAX :148-151 does."""
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._params]

    def clear_grad(self, set_to_zero=False):
        for p in self._params:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # ---------------------------------------------------- state dict
    def state_dict(self):
        """``{<param name>_<accumulator>: tensor}`` (copies), the
        scheduler's state under ``"LR_Scheduler"`` and the step counter
        under ``"@step"`` (JAX :160-169)."""
        out = {}
        for acc_name, store in self._accumulators.items():
            for p in self._params:
                if id(p) in store:
                    out[f"{self._param_name(p)}_{acc_name}"] = (
                        store[id(p)].detach().clone())
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state):
        """The reverse of ``state_dict``: accumulators land in the stored
        tensors when dtype and shape agree (JAX :171-190)."""
        names = {self._param_name(p): p for p in self._params}
        self._step_count = int(state.get("@step", 0))
        if ("LR_Scheduler" in state
                and isinstance(self._learning_rate, LRScheduler)):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        acc_names = set(self._accumulators) | set(self._acc_names)
        for key, val in state.items():
            if key in ("@step", "LR_Scheduler"):
                continue
            for acc_name in acc_names:
                suffix = "_" + acc_name
                if key.endswith(suffix) and key[:-len(suffix)] in names:
                    p = names[key[:-len(suffix)]]
                    cur = self._accumulators.get(acc_name, {}).get(id(p))
                    like = p if cur is None else cur
                    self._set_acc(acc_name, p, torch.as_tensor(val).to(
                        device=like.device, dtype=like.dtype))
                    break


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, p, pval, g, lr, step):
        g = self._apply_decay(pval, g)
        return _promoted(pval, lr) - lr * _promoted(g, lr)


class Momentum(Optimizer):
    """v = momentum * v + g; p - lr * v, or with ``use_nesterov``
    p - lr * (g + momentum * v); ``weight_decay`` is L2 folded into g."""

    _acc_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, p, pval, g, lr, step):
        g = self._apply_decay(pval, g)
        v = self._momentum * self._acc("velocity", p) + g
        self._set_acc("velocity", p, v)
        d = g + self._momentum * v if self._nesterov else v
        return _promoted(pval, lr) - lr * _promoted(d, lr)


class Adam(Optimizer):
    _acc_names = ("moment1", "moment2", "moment2_max")

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
