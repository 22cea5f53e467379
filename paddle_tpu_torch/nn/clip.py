"""Gradient clipping — the counterpart of ``paddle_tpu/nn/clip.py``
(``ClipGradByGlobalNorm``) and of the global-norm branch of
``paddle_tpu/jit/train.py::_functional_clip`` (:29-36)."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Scale every gradient by min(clip_norm / max(||g||, 1e-12), 1), with
    the global norm summed in f32 over all gradients in order."""

    def __init__(self, clip_norm):
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
        """The TrainStep form: every gradient of the list takes part."""
        if not grads:
            return grads
        s = self.scale(grads)
        return [self.apply(g, s) for g in grads]

    def __call__(self, params_grads):
        """The eager form over (param, grad) pairs; grads of None and params
        with ``need_clip = False`` are left out, as in the JAX package."""
        def clipped(p, g):
            return g is not None and getattr(p, "need_clip", True)

        live = [g for p, g in params_grads if clipped(p, g)]
        if not live:
            return params_grads
        s = self.scale(live)
        return [(p, self.apply(g, s) if clipped(p, g) else g)
                for p, g in params_grads]
