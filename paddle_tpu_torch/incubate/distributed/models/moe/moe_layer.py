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
``min(gate.capacity_for(T), T)`` with T this rank's tokens; dropped
tokens give zero rows (``dropped`` counts them, on the device); the
balance loss is ``l_aux`` and ``gate.set_loss``'s, and a
``jit.TrainStep`` adds a fresh ``l_aux`` to the objective, as JAX's does.

Expert parallelism. The expert axis is ``moe_group=`` (a process group),
else the global mesh's "ep" or "moe" axis when its size is above 1, as
JAX finds it (``moe_layer.py:26-34``); it is read when the layer is
built. Over an expert group of ep ranks, rank j keeps experts
``[j E / ep, (j + 1) E / ep)`` of the list given (``E % ep`` must be 0).
A forward routes this rank's tokens, sends the ``[E, C, d]`` dispatch
buffer through the exchange of ``distributed.utils.global_scatter``
(``moe_utils.exchange``; rank-major: block j holds the rows for rank j's
experts), runs the local experts on the ``[E / ep, ep C, d]`` rows that
arrive, returns them through the same exchange (``global_gather``) and
combines as on one device. The capacity is per source rank, the layout
of JAX's ``global_scatter``, so the ranks of an expert group must route
the same capacity (the exchange's blocks are of one size). The gate's balance
statistics are taken over the routing group (the mesh's ranks, or
``moe_group``): its per-expert sums and token count are all-reduced
before the product, so ``l_aux`` is JAX's whole-batch value. Each local
expert parameter carries ``_expert_group``, the ranks that hold the same
experts (the mesh's other axes at this rank's ep coordinate), and
``_ep_group``: ``parallel.GradientSync`` sums its gradient over
``_expert_group`` only, and the hybrid clip adds its square once across
``_ep_group``. Under ``GradientSync`` the layer and its gate hold this
rank's share of the data-parallel batch (``_loss_share``): the gradients
the exchange and the statistics' all-reduce send back to other ranks
carry the sender's weight, so uneven batches weight each rank's loss as
JAX's whole-batch mean does. ``mp_group=`` is accepted and never read by
JAX; the port raises when it is given (ROADMAP C, arguments JAX does not
read).
"""
from __future__ import annotations

import numpy as np
import torch

from .....distributed.utils.moe_utils import exchange
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

    # this rank's share of the data-parallel batch (parallel.GradientSync)
    _loss_share = None

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, dispatch_mode=None,
                 **kwargs):
        super().__init__()
        if mp_group is not None:
            raise NotImplementedError(
                "MoELayer(mp_group=): JAX accepts it and never reads it; "
                "the port raises rather than ignore it (ROADMAP C)")
        if dispatch_mode not in (None, "index", "dense"):
            raise ValueError(f"dispatch_mode must be None, 'index' or "
                             f"'dense', got {dispatch_mode!r}")
        self.d_model = d_model
        experts = list(experts)
        self.num_expert = len(experts)
        self.ep_group, stats_group, expert_group = _expert_groups(
            moe_group, self.num_expert)
        if self.ep_group is not None:
            n = self.num_expert // self.ep_group.nranks
            lo = self.ep_group.rank * n
            experts = experts[lo:lo + n]
        self.experts = LayerList(experts)
        if self.ep_group is not None:
            for e in self.experts:
                for p in torch.nn.Module.parameters(e):
                    p._expert_group = expert_group
                    p._ep_group = self.ep_group
        if gate is None:
            gate = "gshard"
        if isinstance(gate, dict):
            gate = gate.get("type", "gshard")
        if isinstance(gate, str):
            gate = {"gshard": GShardGate, "switch": SwitchGate,
                    "naive": NaiveGate}[gate](d_model, self.num_expert)
        if not isinstance(gate, BaseGate):
            raise TypeError(f"gate must be a BaseGate, got {type(gate)}")
        self.gate = gate
        gate._stats_group = stats_group
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
        self.dropped = None
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
        """[E_local, rows, d] expert outputs for the dispatched rows
        ``disp``."""
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
        E = self.num_expert
        C = min(self.gate.capacity_for(T), T)
        g = self.ep_group
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
                self.dropped = (~keeps).sum()
            else:
                combine, dispatch, l_aux = gate.route(logits, C)
                self.dropped = gate.top_k * T - dispatch.sum()
                combine = combine.to(xf.dtype)
                disp = torch.einsum("tec,td->ecd", dispatch.to(xf.dtype), xf)
            if g is not None:
                # block j (rank j's experts) to rank j; [ep, E/ep, C, d]
                # arrives, each local expert takes its rows of every rank
                ep = g.nranks
                recv = exchange(disp.reshape(E * C, d), g, self._loss_share)
                disp = recv.reshape(ep, E // ep, C, d).transpose(0, 1) \
                    .reshape(E // ep, ep * C, d)
            if self.recompute_interval > 0:
                from .....distributed.fleet.recompute import recompute

                eo = recompute(lambda dd, *pv: self._run_experts(names, pv,
                                                                 dd),
                               disp, *pvals)
            else:
                eo = self._run_experts(names, pvals, disp)
            if g is not None:
                ep = g.nranks
                eo = eo.reshape(E // ep, ep, C, d).transpose(0, 1) \
                    .reshape(E * C, d)
                eo = exchange(eo, g, self._loss_share).reshape(E, C, d)
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


def _expert_groups(moe_group, num_expert):
    """(ep group, routing group, expert data group) of a layer of
    ``num_expert`` experts: ``moe_group`` or the global mesh's "ep" /
    "moe" axis, the ranks whose tokens the gate's statistics cover, and
    the ranks that hold the same experts as this one. (None, None, None)
    without expert parallelism."""
    from .....distributed import collective, env
    from .....distributed.mesh import get_mesh

    if moe_group is not None:
        ep = moe_group.nranks
        if env.get_world_size() % ep:
            raise ValueError(f"an expert group of {ep} ranks does not tile "
                             f"a world of {env.get_world_size()}")
        ids = np.arange(env.get_world_size()).reshape(-1, ep)
        if list(ids[env.get_rank() // ep]) != list(moe_group.ranks):
            raise ValueError(f"moe_group {moe_group.ranks} is not a block "
                             f"of {ep} consecutive ranks")
        group, routing = moe_group, moe_group
    else:
        mesh = get_mesh()
        axis = None
        if mesh is not None and mesh.contains():
            axis = next((n for n in ("ep", "moe") if n in mesh.dim_names
                         and mesh.get_dim_size(n) > 1), None)
        if axis is None:
            return None, None, None
        group, ep = mesh.get_group(axis), mesh.get_dim_size(axis)
        ids = np.moveaxis(mesh.mesh, mesh.dim_names.index(axis),
                          -1).reshape(-1, ep)
        routing = (collective._world()
                   if len(mesh.process_ids) == env.get_world_size()
                   else collective.new_group(mesh.process_ids))
    if num_expert % ep:
        raise ValueError(f"{num_expert} experts do not split over an "
                         f"expert-parallel group of {ep} ranks")
    expert_group = None
    for j in range(ep):             # every rank makes every group
        grp = collective.new_group([int(r) for r in ids[:, j]])
        if env.get_rank() in grp.ranks:
            expert_group = grp
    return group, routing, expert_group
