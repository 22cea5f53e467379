"""Optimizers — the counterpart of ``paddle_tpu/optimizer/__init__.py``
(``Optimizer`` :39-194, ``SGD`` :196-206, ``Momentum`` :209-227, ``Adam``
:230-265, ``AdamW`` :268-303, ``Adamax`` :306, ``Adagrad`` :326,
``Adadelta`` :343, ``RMSProp`` :363, ``Lamb`` :390, ``LBFGS`` :423,
``ASGD`` :487, ``Rprop`` :521, ``NAdam`` :559, ``RAdam`` :601) and of its
learning-rate schedulers (``lr.py``).

Accumulators (moments, velocities) are kept per parameter, created by
``_acc_init`` (zeros in the parameter's dtype unless an optimizer says
otherwise) at first use or, under ``jit.TrainStep``, before the step's
first run (``_acc_names``). A stored
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
scheduler's current rate and the caller steps it. ``LBFGS`` takes a closure
and decides on the host between evaluations: it runs eagerly only
(``jit.TrainStep`` refuses it).
"""
from __future__ import annotations

import numbers

import torch

from . import lr
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LBFGS", "ASGD", "NAdam",
           "RAdam", "Rprop", "lr"]


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


def _mul(s, x):
    """s * x with x promoted by the scalar s first (JAX's strong-scalar
    rule, see ``_promoted``)."""
    return s * _promoted(x, s)


def _div(x, s):
    """x / s with x promoted by the scalar s first."""
    return _promoted(x, s) / s


def _step_f32(step, like):
    """The step counter as an f32 0-d tensor on ``like``'s device (JAX's
    ``jnp.asarray(t, jnp.float32)``, a strong scalar in either path)."""
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.full((), float(step), dtype=torch.float32,
                      device=like.device)


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
    ``param_<i>``). A parameter is a torch tensor or an ``nn.Parameter``
    (a ``Layer``'s); the optimizer updates the torch tensor and reads the
    paddle attributes of the second: ``optimize_attr["learning_rate"]``
    scales the rate (JAX :113-114), ``regularizer`` replaces
    ``weight_decay`` (:133-146) and ``need_clip`` False exempts it from
    the clip."""

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
        self._attrs = {}      # id(torch tensor) -> its nn.Parameter
        for g in groups:
            named = [(n, self._torch(p)) for n, p in
                     _named(g["params"], len(self._params))]
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

    def _torch(self, p):
        """The torch tensor of parameter ``p``; an ``nn.Parameter``'s
        paddle attributes are kept for it."""
        value = getattr(p, "_value", None)
        if value is None:
            return p
        self._attrs[id(value)] = p
        return value

    def _lr_scale(self, p):
        """``optimize_attr["learning_rate"]`` of torch tensor ``p``'s
        parameter (1.0 without one)."""
        attr = getattr(self._attrs.get(id(p)), "optimize_attr", None)
        return attr.get("learning_rate", 1.0) if attr else 1.0

    # --------------------------------------------------- accumulators
    def _acc_init(self, name, p):
        """The first value of accumulator ``name`` of ``p`` (JAX
        ``_acc_init`` :67-72): zeros like the parameter."""
        return torch.zeros_like(p.detach())

    def _acc(self, name, p, init=None):
        """The stored accumulator, made on first use by ``init()`` when
        given (the eager path's own first value), else ``_acc_init``."""
        store = self._accumulators.setdefault(name, {})
        if id(p) not in store:
            store[id(p)] = init() if init is not None else self._acc_init(
                name, p)
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
        params_grads = [(self._attrs.get(id(p), p), p.grad)
                        for p in self._params
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        for q, g in params_grads:
            if g is None:
                continue
            p = getattr(q, "_value", q)
            lr = self.get_lr() * self._lr_scale(p)
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

    def _apply_decay(self, p, pval, g):
        """L2 regularisation folded into the gradient (paddle's
        weight_decay for optimizers other than AdamW): the parameter's own
        ``regularizer``, else the optimizer's ``weight_decay``, either a
        number or an object with ``_coeff`` (JAX :133-146), the coefficient
        rounded to g's dtype first."""
        wd = getattr(self._attrs.get(id(p)), "regularizer", None)
        if wd is None:
            wd = self._weight_decay
        wd = getattr(wd, "_coeff", wd)
        if isinstance(wd, numbers.Real) and wd != 0.0:
            wd = float(torch.tensor(wd, dtype=g.dtype, device="cpu"))
            return g + wd * pval
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
                    t = store[id(p)]
                    c = out[f"{self._param_name(p)}_{acc_name}"] = (
                        t.detach().clone())
                    if hasattr(t, "_global_shape"):
                        # where a ZeRO / tensor-parallel part sits
                        # (distributed.layout), for the checkpoint
                        c._global_shape = t._global_shape
                        c._global_pieces = t._global_pieces
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
        g = self._apply_decay(p, pval, g)
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
        g = self._apply_decay(p, pval, g)
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
        g = self._apply_decay(p, pval, g)
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
        self._wd_coeff = getattr(weight_decay, "_coeff", weight_decay)
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


class Adamax(Optimizer):
    """m = b1 m + (1 - b1) g; u = max(b2 u, |g|); p - lr / (1 - b1^t) m /
    (u + eps)."""

    _acc_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _update(self, p, pval, g, lr, step):
        g = self._apply_decay(p, pval, g)
        m = self._beta1 * self._acc("moment", p) + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * self._acc("inf_norm", p), g.abs())
        self._set_acc("moment", p, m)
        self._set_acc("inf_norm", p, u)
        c = lr / (1 - _pow_step(self._beta1, step))
        return _promoted(pval, c) - _mul(c, m) / (u + self._eps)


class Adagrad(Optimizer):
    """acc += g^2; p - lr g / (sqrt(acc) + eps). The eager path starts acc
    at ``initial_accumulator_value``; under ``jit.TrainStep`` it starts at
    0, as the JAX package's TrainStep does (``_acc_init``)."""

    _acc_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _update(self, p, pval, g, lr, step):
        g = self._apply_decay(p, pval, g)
        acc = self._acc("moment", p, lambda: torch.full_like(
            p.detach(), self._init_acc)) + torch.square(g)
        self._set_acc("moment", p, acc)
        return _promoted(pval, lr) - _mul(lr, g) / (torch.sqrt(acc)
                                                    + self._eps)


class Adadelta(Optimizer):
    _acc_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _update(self, p, pval, g, lr, step):
        g = self._apply_decay(p, pval, g)
        rho = self._rho
        avg_sq = (rho * self._acc("avg_squared_grad", p)
                  + (1 - rho) * torch.square(g))
        avg_upd = self._acc("avg_squared_update", p)
        delta = (torch.sqrt(avg_upd + self._eps)
                 / torch.sqrt(avg_sq + self._eps) * g)
        avg_upd = rho * avg_upd + (1 - rho) * torch.square(delta)
        self._set_acc("avg_squared_grad", p, avg_sq)
        self._set_acc("avg_squared_update", p, avg_upd)
        return _promoted(pval, lr) - _mul(lr, delta)


class RMSProp(Optimizer):
    """ms = rho ms + (1 - rho) g^2 (centered: minus the square of the mean
    gradient); mom = momentum mom + lr g / sqrt(ms + eps); p - mom."""

    _acc_names = ("mean_square", "mean_grad", "momentum")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update(self, p, pval, g, lr, step):
        g = self._apply_decay(p, pval, g)
        rho = self._rho
        ms = rho * self._acc("mean_square", p) + (1 - rho) * torch.square(g)
        self._set_acc("mean_square", p, ms)
        if self._centered:
            mg = rho * self._acc("mean_grad", p) + (1 - rho) * g
            self._set_acc("mean_grad", p, mg)
            denom = torch.sqrt(ms - torch.square(mg) + self._eps)
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = (self._momentum * self._acc("momentum", p)
               + _mul(lr, g) / denom)
        self._set_acc("momentum", p, mom)
        return pval - mom


class Lamb(Optimizer):
    """Adam's direction r plus ``lamb_weight_decay`` p, scaled by the trust
    ratio ||p|| / ||update|| (1 where either norm is 0);
    ``exclude_from_weight_decay_fn(p)`` True exempts p from the decay."""

    _acc_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, p, pval, g, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = b1 * self._acc("moment1", p) + (1 - b1) * g
        v = b2 * self._acc("moment2", p) + (1 - b2) * torch.square(g)
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        mhat = _div(m, 1 - _pow_step(b1, step))
        vhat = _div(v, 1 - _pow_step(b2, step))
        r = mhat / (torch.sqrt(vhat) + self._eps)
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        update = r + wd * pval
        w_norm = torch.linalg.vector_norm(pval.float())
        u_norm = torch.linalg.vector_norm(update.float())
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones((), device=pval.device)).to(pval.dtype)
        return pval - _mul(lr * trust, update)


class LBFGS(Optimizer):
    """Limited-memory BFGS over all parameters flattened in f32 (JAX
    :423-484, reference ``python/paddle/optimizer/lbfgs.py``): ``step``
    evaluates the closure, records the (s, y) pair when y.s > 1e-10, and
    moves every parameter by lr along the two-loop direction. It reads y.s
    on the host each step: eager only."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter
        self._history_size = history_size
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = []          # (s, y, rho)
        self._prev_flat_grad = None
        self._prev_flat_w = None

    @staticmethod
    def _flatten(vals):
        return torch.cat([v.reshape(-1) for v in vals])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        params = self._params
        with torch.enable_grad():
            loss = closure()
        flat_g = self._flatten([p.grad if p.grad is not None
                                else torch.zeros_like(p)
                                for p in params]).float()
        flat_w = self._flatten([p.detach() for p in params]).float()
        if self._prev_flat_grad is not None:
            s = flat_w - self._prev_flat_w
            y = flat_g - self._prev_flat_grad
            ys = float(torch.dot(y, s))
            if ys > 1e-10:
                self._history.append((s, y, 1.0 / ys))
                if len(self._history) > self._history_size:
                    self._history.pop(0)
        q = flat_g
        alphas = []
        for s, y, rho in reversed(self._history):
            a = rho * torch.dot(s, q)
            alphas.append(a)
            q = q - a * y
        if self._history:
            s, y, _ = self._history[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for (s, y, rho), a in zip(self._history, reversed(alphas)):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        new_w = flat_w - self.get_lr() * q
        offset = 0
        for p in params:
            n = p.numel()
            p.copy_(new_w[offset:offset + n].reshape(p.shape).to(p.dtype))
            offset += n
        self._prev_flat_grad = flat_g
        self._prev_flat_w = flat_w
        self._step_count += 1
        return loss


class ASGD(Optimizer):
    """Averaged SGD (JAX :487-518): d is the sum of the last ``batch_num``
    gradients, kept with a ring of them (``ys``, written in place at slot
    (t - 1) mod n); p - lr d / min(t, n)."""

    _acc_names = ("d", "ys")

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._n = max(1, int(batch_num))

    def _acc_init(self, name, p):
        if name == "ys":
            return torch.zeros((self._n,) + tuple(p.shape), dtype=p.dtype,
                               device=p.device)
        return super()._acc_init(name, p)

    def _update(self, p, pval, g, lr, step):
        g = self._apply_decay(p, pval, g)
        ys = self._acc("ys", p)
        # the slot of this step, on the device when the counter is there
        i = (step - 1) % self._n
        idx = (i.reshape(1).long() if isinstance(i, torch.Tensor)
               else torch.full((1,), i, dtype=torch.long, device=g.device))
        d = self._acc("d", p) - ys.index_select(0, idx)[0] + g
        # in the ring's dtype (JAX's .at[].set): the parameter's
        ys.index_copy_(0, idx, g[None].to(ys.dtype))
        self._set_acc("d", p, d)
        self._set_acc("ys", p, ys)
        seen = torch.clamp(_step_f32(step, g), max=float(self._n))
        return _promoted(pval, lr, seen) - _div(_mul(lr, d), seen)


class Rprop(Optimizer):
    """Resilient backprop, iRprop- (JAX :521-556): per-element step sizes
    (f32, starting at the learning rate) grown by ``etas[1]`` where the
    gradient keeps its sign, shrunk by ``etas[0]`` where it flips (and the
    gradient taken as 0 there), clipped to ``learning_rate_range``;
    p - sign(g) step."""

    _acc_names = ("prev_grad", "step_size")

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_minus, self._eta_plus = etas

    def _acc_init(self, name, p):
        if name == "step_size":
            return torch.full(tuple(p.shape), float(self.get_lr()),
                              dtype=torch.float32, device=p.device)
        return super()._acc_init(name, p)

    def _update(self, p, pval, g, lr, step):
        prev = self._acc("prev_grad", p)
        size = self._acc("step_size", p)
        sign = torch.sign(g * prev)
        grow = (sign > 0).float()
        shrink = (sign < 0).float()
        same = (sign == 0).float()
        size = torch.clamp(size * (grow * self._eta_plus
                                   + shrink * self._eta_minus + same),
                           self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, torch.zeros((), dtype=g.dtype,
                                                  device=g.device), g)
        self._set_acc("prev_grad", p, g_eff)
        self._set_acc("step_size", p, size)
        return pval - torch.sign(g_eff).to(pval.dtype) * size.to(pval.dtype)


class NAdam(Adam):
    """Adam with Nesterov momentum (Dozat 2016; JAX :559-598): the momentum
    schedule mu_t = b1 (1 - 0.5 * 0.96^(t psi)), its running product
    (an f32 scalar accumulator), and the look-ahead first moment."""

    _acc_names = ("moment1", "moment2", "mu_prod")

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision, name=name)
        self._psi = momentum_decay

    def _acc_init(self, name, p):
        if name == "mu_prod":
            return torch.ones((), dtype=torch.float32, device=p.device)
        return super()._acc_init(name, p)

    def _update(self, p, pval, g, lr, step):
        g = self._apply_decay(p, pval, g)
        b1, b2 = self._beta1, self._beta2
        mu_t = b1 * (1 - 0.5 * _pow_step(0.96, step * self._psi))
        mu_t1 = b1 * (1 - 0.5 * _pow_step(0.96, (step + 1) * self._psi))
        mu_prod = self._acc("mu_prod", p) * mu_t
        self._set_acc("mu_prod", p, mu_prod)
        m = b1 * self._acc("moment1", p) + (1 - b1) * g
        v = b2 * self._acc("moment2", p) + (1 - b2) * torch.square(g)
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        mhat = (_div(_mul(mu_t1, m), 1 - mu_prod * mu_t1)
                + _div(_mul(1 - mu_t, g), 1 - mu_prod))
        vhat = _div(v, 1 - _pow_step(b2, step))
        return _promoted(pval, lr) - _mul(lr, mhat) / (torch.sqrt(vhat)
                                                       + self._eps)


class RAdam(Adam):
    """Rectified Adam (JAX :601-628): SGD with momentum while the variance
    estimate is unreliable (rho_t <= 5), the rectified Adam step after."""

    def _update(self, p, pval, g, lr, step):
        g = self._apply_decay(p, pval, g)
        b1, b2 = self._beta1, self._beta2
        m = b1 * self._acc("moment1", p) + (1 - b1) * g
        v = b2 * self._acc("moment2", p) + (1 - b2) * torch.square(g)
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        mhat = _div(m, 1 - _pow_step(b1, step))
        rho_inf = 2.0 / (1 - b2) - 1.0
        tf = _step_f32(step, g)
        b2t = torch.pow(torch.full((), b2, dtype=torch.float32,
                                   device=g.device), tf)
        rho_t = rho_inf - 2.0 * tf * b2t / (1 - b2t)
        vhat = torch.sqrt(_div(v, 1 - b2t))
        rect_num = torch.clamp((rho_t - 4) * (rho_t - 2) * rho_inf, min=0.0)
        r = torch.sqrt(rect_num / ((rho_inf - 4) * (rho_inf - 2)
                                   * torch.clamp(rho_t, min=1e-6)))
        adapted = (_promoted(pval, lr, r)
                   - _mul(lr * r, mhat) / (vhat + self._eps))
        plain = _promoted(pval, lr) - _mul(lr, mhat)
        return torch.where(rho_t > 5.0, adapted, plain)
