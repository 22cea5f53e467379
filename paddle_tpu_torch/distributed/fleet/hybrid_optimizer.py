"""``HybridParallelOptimizer`` — the counterpart of
``paddle_tpu/distributed/fleet/hybrid_optimizer.py`` (Paddle
``hybrid_parallel_optimizer.py:275``).

The JAX package's gradients are global arrays, so its clip already sees
every shard, and its single process sees the whole model. A rank of the
port holds only its shards of its pipeline stage. Its gradients are
already synced when the backward ends (the model wrapper's
``parallel.GradientSync``: averaged over dp x sep, the
``sequence_parallel`` ones summed over mp; or the pipeline's and the ZeRO
stage's syncs), so the wrapper only clips by the global norm
(``HybridParallelClipGrad``): each rank sums the squares of the
gradients it alone holds, and the sum is all-reduced over the
model-parallel group, the ZeRO stage's group and the pipe group in turn
(orthogonal axes: the sum over their product). A gradient replicated
along one of them counts on that group's first rank only; a shared
(tied) weight's copy on a later stage does not count
(``_pp_shared_copy``). Expert parameters of an expert-parallel MoE layer
(``_ep_group``) are different experts on each rank of that group: their
squares are summed over it, and every other gradient, the same on each
of its ranks, counts on its first rank only.

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
    # the flag a tensor-parallel cut sets: a torch tensor's own
    # ``is_distributed`` is a method
    return getattr(getattr(p, "_value", p), "is_distributed", False) is True


def _live(g):
    return g if g is not None and g.nranks > 1 else None


class HybridParallelClipGrad(ClipGradBase):
    """Global-norm clip over the model-parallel ``group``, the ZeRO
    ``zero_group`` (gradients of ``_zero_sliced`` parameters are rows) and
    the ``pp_group`` (each rank holds one stage)."""

    needs_params = True

    def __init__(self, clip, group=None, zero_group=None, pp_group=None):
        self._clip = clip
        self.clip_norm = clip.clip_norm
        self.group = group
        self.zero_group = zero_group
        self.pp_group = pp_group

    def clip_params(self, params, grads):
        if not grads:
            return grads
        dev = grads[0].device
        mp, zero = _live(self.group), _live(self.zero_group)
        ep = _live(next((getattr(p, "_ep_group", None) for p in params
                         if getattr(p, "_ep_group", None) is not None),
                        None))
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for p, g in zip(params, grads):
            if getattr(p, "_pp_shared_copy", False):
                continue
            if mp is not None and not _is_sharded(p) and mp.rank != 0:
                continue
            if (zero is not None and not getattr(p, "_zero_sliced", False)
                    and zero.rank != 0):
                continue
            if (ep is not None and getattr(p, "_ep_group", None) is None
                    and ep.rank != 0):
                continue
            total = total + g.float().square().sum()
        for grp in (mp, zero, _live(self.pp_group), ep):
            if grp is not None:
                _all_reduce_(total, "sum", grp)
        gnorm = torch.sqrt(total)
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
        inner = getattr(optimizer, "_inner_opt", optimizer)
        mp = hcg.get_model_parallel_group()
        pp = hcg.get_pipe_parallel_group()
        sharding = hcg.get_sharding_parallel_group()
        clip = inner._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm) and max(
                mp.nranks, pp.nranks, sharding.nranks) > 1:
            inner._grad_clip = HybridParallelClipGrad(
                clip, mp, zero_group=None, pp_group=pp)
        elif isinstance(clip, HybridParallelClipGrad):
            clip.group, clip.pp_group = mp, pp

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
