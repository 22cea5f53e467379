"""``HybridParallelOptimizer`` — the counterpart of
``paddle_tpu/distributed/fleet/hybrid_optimizer.py`` (Paddle
``hybrid_parallel_optimizer.py:275``).

The JAX package's gradients are global arrays, so its clip already sees
every shard. A rank of the port holds only its shards. Its gradients are
already synced when the backward ends (the model wrapper's
``parallel.GradientSync``: averaged over dp x sep, the
``sequence_parallel`` ones summed over mp), so the wrapper only clips by
the global norm across the model-parallel group
(``HybridParallelClipGrad``): a sharded parameter's squared norm is
all-reduced once, a replicated one counted once.

The inner optimizer's clip is replaced by the hybrid one, so a
``jit.TrainStep`` (which updates through the inner optimizer) clips the
same way.
"""
from __future__ import annotations

import torch

from ...nn.clip import ClipGradBase, ClipGradByGlobalNorm
from ..collective import _all_reduce_

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad"]


def _is_sharded(p):
    return bool(getattr(getattr(p, "_value", p), "is_distributed", False))


class HybridParallelClipGrad(ClipGradBase):
    """Global-norm clip over a model-parallel group: the squared norms of
    the sharded parameters' gradients are summed over the group in one
    all-reduce, the replicated ones added once."""

    needs_params = True

    def __init__(self, clip, group):
        self._clip = clip
        self.clip_norm = clip.clip_norm
        self.group = group

    def clip_params(self, params, grads):
        if not grads:
            return grads
        dev = grads[0].device
        sharded = torch.zeros((), dtype=torch.float32, device=dev)
        replicated = torch.zeros((), dtype=torch.float32, device=dev)
        for p, g in zip(params, grads):
            sq = g.float().square().sum()
            if _is_sharded(p):
                sharded = sharded + sq
            else:
                replicated = replicated + sq
        if self.group is not None and self.group.nranks > 1:
            _all_reduce_(sharded, "sum", self.group)
        gnorm = torch.sqrt(sharded + replicated)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        return [ClipGradByGlobalNorm.apply(g, scale) for g in grads]

    def clip(self, grads):
        raise TypeError("HybridParallelClipGrad needs the parameters: "
                        "call clip_params(params, grads)")

    def __call__(self, params_grads):
        live = [(p, g) for p, g in params_grads
                if g is not None and getattr(p, "need_clip", True)]
        if not live:
            return params_grads
        done = iter(self.clip_params([p for p, _ in live],
                                     [g for _, g in live]))
        return [(p, next(done) if g is not None
                 and getattr(p, "need_clip", True) else g)
                for p, g in params_grads]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        mp = hcg.get_model_parallel_group()
        clip = optimizer._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm) and mp.nranks > 1:
            optimizer._grad_clip = HybridParallelClipGrad(clip, mp)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._inner_opt._params]

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)
