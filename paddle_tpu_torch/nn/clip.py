"""Gradient clipping — the counterpart of ``paddle_tpu/nn/clip.py``
(``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``), of
``paddle_tpu/nn/utils`` (``clip_grad_norm_``, ``clip_grad_value_``) and of
``paddle_tpu/jit/train.py::_functional_clip`` (:29-45).

Each clip has two forms: ``clip(grads)``, the TrainStep's, where every
gradient of the list takes part; and ``__call__(params_grads)``, the eager
optimizer's, over (param, grad) pairs, where grads of None and parameters
with ``need_clip = False`` are left as they are."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def clip(self, grads):
        """The clipped gradients of the list (the TrainStep form)."""
        raise NotImplementedError

    def __call__(self, params_grads):
        """The eager form: ``clip`` over the pairs that take part."""
        live = [g for p, g in params_grads if _clipped(p, g)]
        if not live:
            return params_grads
        done = iter(self.clip(live))
        return [(p, next(done) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByValue(ClipGradBase):
    """Every gradient element clamped to [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def clip(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by min(clip_norm / max(||g||, 1e-12), 1), its
    own L2 norm taken in its own dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def clip(self, grads):
        out = []
        for g in grads:
            n = torch.sqrt(torch.sum(torch.square(g)))
            out.append(g * torch.clamp(
                self.clip_norm / torch.clamp(n, min=1e-12), max=1.0))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by min(clip_norm / max(||g||, 1e-12), 1), with
    the global norm summed in f32 over all gradients in order."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def scale(self, grads):
        """The f32 scalar the gradients are multiplied by."""
        sq = sum(g.float().square().sum() for g in grads)
        gnorm = torch.sqrt(sq)
        return torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                           max=1.0)

    @staticmethod
    def apply(g, scale):
        """g * scale in f32 (the scale is a strong f32 scalar in the JAX
        package), cast back to g's dtype."""
        return (g.to(torch.promote_types(g.dtype, scale.dtype))
                * scale).to(g.dtype)

    def clip(self, grads):
        if not grads:
            return grads
        s = self.scale(grads)
        return [self.apply(g, s) for g in grads]


def _grads(parameters):
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    return [p for p in parameters if p.grad is not None]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients of ``parameters`` in place by
    min(max_norm / (total + 1e-6), 1) in f32, where total is their joint
    ``norm_type`` norm summed in f32 (inf: the largest |g|); returns total
    (``paddle_tpu/nn/utils/__init__.py:117-137``)."""
    params = _grads(parameters)
    if not params:
        return torch.zeros(())
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.max(torch.stack([g.abs().max() for g in grads]))
    else:
        total = torch.pow(sum(torch.sum(torch.pow(g.float().abs(), norm_type))
                              for g in grads), 1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite total norm in clip_grad_norm_")
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in params:
        p.grad = (p.grad.float() * scale).to(p.grad.dtype)
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp the gradients of ``parameters`` to [-clip_value, clip_value]
    (``paddle_tpu/nn/utils/__init__.py:140-145``)."""
    for p in _grads(parameters):
        p.grad = torch.clamp(p.grad, -clip_value, clip_value)
