"""MoELayer — the counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``. Reference:
python/paddle/incubate/distributed/models/moe/moe_layer.py:261 (gate ->
dispatch -> experts -> combine).

Two dispatch modes take the gate's same decisions:

* ``"index"`` (the default when the gate gives ``route_indices``): each
  kept (round, token) owns slot ``e * C + loc`` of an [E * C] table; a
  dropped one points at the sentinel slot ``E * C``, backed by a zero row.
  The experts' inputs are a gather, the output a gather of the experts'
  rows weighted by the gate values (f32) and summed over the rounds:
  O(k T d).
* ``"dense"``: the one-hot einsums over [T, E, C] (GShard), O(T E C d),
  the parity oracle.

Uniform experts (one parameter layout) run as one batched call over their
stacked parameters (``torch.func.vmap`` of ``torch.func.functional_call``
of the first expert); others one by one. ``recompute_interval`` > 0 puts
the experts under ``distributed.fleet.recompute``. Capacity is
``min(gate.capacity_for(T), T)``; dropped tokens give zero rows; the
balance loss is ``l_aux`` and ``gate.set_loss``'s, and a ``jit.TrainStep``
adds a fresh ``l_aux`` to the objective, as JAX's does. The port has no
device mesh yet (ROADMAP item 5): the layer runs on one device, as JAX's
does without a mesh, and ``moe_group`` / ``mp_group`` raise.
"""
from __future__ import annotations

import torch

from .....nn.layer import Layer
from .....nn.layer_common import LayerList
from .....ops import apply_like
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer"]


class MoELayer(Layer):
    """Mixture of experts over ``experts`` (a list or LayerList of
    Layers) routed by ``gate`` (a ``BaseGate``, or "gshard" | "switch" |
    "naive", or a dict whose "type" names one). After a forward
    ``l_aux`` holds the load-balance loss (also ``gate.get_loss()``)."""

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, dispatch_mode=None,
                 **kwargs):
        super().__init__()
        if moe_group is not None or mp_group is not None:
            raise NotImplementedError(
                "MoELayer(moe_group= / mp_group=): expert and model "
                "parallelism need the device mesh of ROADMAP item 5; the "
                "layer runs on one device")
        if dispatch_mode not in (None, "index", "dense"):
            raise ValueError(f"dispatch_mode must be None, 'index' or "
                             f"'dense', got {dispatch_mode!r}")
        self.d_model = d_model
        self.experts = (experts if isinstance(experts, LayerList)
                        else LayerList(experts))
        if gate is None:
            gate = "gshard"
        if isinstance(gate, dict):
            gate = gate.get("type", "gshard")
        if isinstance(gate, str):
            gate = {"gshard": GShardGate, "switch": SwitchGate,
                    "naive": NaiveGate}[gate](d_model, len(self.experts))
        if not isinstance(gate, BaseGate):
            raise TypeError(f"gate must be a BaseGate, got {type(gate)}")
        self.gate = gate
        has_indices = hasattr(gate, "route_indices")
        if dispatch_mode == "index" and not has_indices:
            raise ValueError(
                "dispatch_mode='index' requires the gate to implement "
                f"route_indices; {type(gate).__name__} does not — pass "
                "dispatch_mode='dense' or None (auto)")
        self.dispatch_mode = dispatch_mode or ("index" if has_indices
                                               else "dense")
        self.recompute_interval = recompute_interval
        self.l_aux = None
        self._uniform = self._check_uniform()

    def _param_names(self, expert):
        return [n for n, _ in torch.nn.Module.named_parameters(expert)]

    def _check_uniform(self):
        if not len(self.experts):
            return False
        layouts = {tuple((n, tuple(p.shape)) for n, p in
                         torch.nn.Module.named_parameters(e))
                   for e in self.experts}
        return len(layouts) == 1

    def _run_experts(self, names, pvals, disp):
        """[E, C, d] expert outputs for the dispatched rows ``disp``."""
        E, P = len(self.experts), len(names)
        if self._uniform:
            stacked = {n: torch.stack([pvals[e * P + i] for e in range(E)])
                       for i, n in enumerate(names)}
            first = self.experts[0]

            def one(params, xe):
                return torch.func.functional_call(first, params, (xe,))

            return torch.func.vmap(one)(stacked, disp)
        return torch.stack([
            torch.func.functional_call(
                self.experts[e], {n: pvals[e * P + i]
                                  for i, n in enumerate(names)}, (disp[e],))
            for e in range(E)])

    def forward(self, x):
        shape = list(x.shape)
        d = shape[-1]
        T = 1
        for s in shape[:-1]:
            T *= s
        E = len(self.experts)
        C = min(self.gate.capacity_for(T), T)
        names = self._param_names(self.experts[0])
        params = [p for e in self.experts
                  for p in (dict(torch.nn.Module.named_parameters(e))[n]
                            for n in names)]
        gate = self.gate
        index_mode = self.dispatch_mode == "index"

        def f(xv, gw, *pvals):
            xf = xv.reshape(T, d)
            logits = xf @ gw.to(xf.dtype)
            if index_mode:
                eids, locs, keeps, gvals, l_aux = gate.route_indices(logits, C)
                slot = torch.where(keeps, eids.long() * C + locs.long(),
                                   E * C)                       # [k, T]
                t_idx = torch.arange(T, device=xf.device).expand_as(slot)
                token_for = torch.full((E * C + 1,), T, dtype=torch.long,
                                       device=xf.device).scatter(
                    0, slot.reshape(-1), t_idx.reshape(-1))
                x_pad = torch.cat([xf, xf.new_zeros(1, d)])
                disp = x_pad[token_for[:-1]].reshape(E, C, d)
            else:
                combine, dispatch, l_aux = gate.route(logits, C)
                combine = combine.to(xf.dtype)
                disp = torch.einsum("tec,td->ecd", dispatch.to(xf.dtype), xf)
            if self.recompute_interval > 0:
                from .....distributed.fleet.recompute import recompute

                eo = recompute(lambda dd, *pv: self._run_experts(names, pv,
                                                                 dd),
                               disp, *pvals)
            else:
                eo = self._run_experts(names, pvals, disp)
            if index_mode:
                eo_pad = torch.cat([eo.reshape(E * C, d).float(),
                                    eo.new_zeros(1, d, dtype=torch.float32)])
                w = (gvals * keeps).float()                     # [k, T]
                y = (w[..., None] * eo_pad[slot]).sum(dim=0).to(xf.dtype)
            else:
                y = torch.einsum("ecd,tec->td", eo.float(),
                                 combine.float()).to(xf.dtype)
            return y.reshape(shape), l_aux

        y, l_aux = apply_like(f, "moe_layer", x, gate.weight, *params)
        self.l_aux = l_aux
        gate.set_loss(l_aux)
        return y
