"""ASP: automatic 2:4 structured sparsity — the counterpart of
``paddle_tpu/incubate/asp``. Reference: python/paddle/incubate/asp/
(prune_model, decorate, calculate_density, set/reset_excluded_layers).

The n:m masks are JAX's ``mask_1d`` (keep the n largest |w| of every m
consecutive elements along the last axis), computed on the weight's device
(a stable sort, so ties between equal magnitudes keep the earlier
element); execution stays dense with the mask, as in JAX. A ``decorate``d
optimizer re-applies the registered masks after every eager ``step()``;
``jit.TrainStep`` refuses it: JAX's step runs the inner update and drops
the masks (ROADMAP C). Other mask algorithms raise, as in JAX.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ...tensor import Tensor

__all__ = ["calculate_density", "decorate", "prune_model",
           "set_excluded_layers", "reset_excluded_layers", "check_sparsity",
           "OptimizerWithSparsityGuarantee"]

_EXCLUDED: set = set()
# id(param) -> (weakref(param), mask): weakrefs let discarded models be
# collected, and dead entries are dropped on the next decorated step
_MASKS: dict = {}


def _tensor(x):
    x = x._value if isinstance(x, Tensor) else x
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def calculate_density(x) -> float:
    """The fraction of non-zeros (reference asp/utils.py)."""
    t = _tensor(x)
    return float(torch.count_nonzero(t)) / max(t.numel(), 1)


def _mask_1d(mat, n, m):
    """Keep the n largest-|x| of every m consecutive elements along the
    last axis (reference asp/utils.py get_mask_1d)."""
    flat = mat.reshape(-1, m)
    order = torch.argsort(flat.abs(), dim=1, stable=True)
    mask = torch.ones_like(flat, dtype=torch.bool)
    mask.scatter_(1, order[:, :m - n], False)
    return mask.reshape(mat.shape)


def check_sparsity(x, n=2, m=4) -> bool:
    """True iff every m-group along the last axis has at most n
    non-zeros."""
    t = _tensor(x)
    if t.numel() % m:
        return False
    return bool(((t.reshape(-1, m) != 0).sum(dim=1) <= n).all())


def set_excluded_layers(param_names, main_program=None):
    """Skip these parameters (by structured name) in prune_model."""
    _EXCLUDED.update(param_names)


def reset_excluded_layers(main_program=None):
    _EXCLUDED.clear()


def _prunable_params(model):
    for name, p in torch.nn.Module.named_parameters(model):
        if name in _EXCLUDED:
            continue
        # multiplicative weights only (the reference prunes FC / conv
        # kernels, never biases or norms)
        if p.ndim >= 2 and name.endswith("weight") and p.shape[-1] % 4 == 0:
            yield name, p


@torch.no_grad()
def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Apply n:m masks to every prunable weight in place and register them,
    so that ``decorate``d optimizers re-apply them after each step.
    Returns {name: the mask as a numpy bool array}."""
    if mask_algo != "mask_1d":
        raise NotImplementedError(
            f"mask_algo {mask_algo!r}: only 'mask_1d' is implemented (the "
            "reference's mask_2d_* search the 2-D pattern space; silently "
            "substituting mask_1d would diverge numerically)")
    masks = {}
    for name, p in _prunable_params(model):
        mask = _mask_1d(p.detach().reshape(-1, p.shape[-1]), n, m).reshape(
            p.shape)
        p.mul_(mask.to(p.dtype))
        if with_mask:
            _MASKS[id(p)] = (weakref.ref(p), mask.to(p.dtype))
        masks[name] = mask.cpu().numpy()
    return masks


class OptimizerWithSparsityGuarantee:
    """Re-applies the registered masks after every optimizer step, so the
    pruned slots stay zero (reference asp/asp.py)."""

    _step_wrapper_name = "OptimizerWithSparsityGuarantee"

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def __getattr__(self, item):
        return getattr(self.__dict__["_optimizer"], item)

    @torch.no_grad()
    def step(self):
        self._optimizer.step()
        dead = []
        for pid, (ref, mask) in _MASKS.items():
            p = ref()
            if p is None:
                dead.append(pid)
                continue
            p.mul_(mask)
        for pid in dead:
            del _MASKS[pid]


def decorate(optimizer):
    """The optimizer with the sparsity guarantee (reference
    asp.decorate)."""
    return OptimizerWithSparsityGuarantee(optimizer)
