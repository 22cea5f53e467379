"""Rank bodies for the multi-rank tests of SyncBatchNorm, expert
parallelism, tensor-parallel LLaMA / BERT, LoRA and the self-drafter
under tensor parallelism, the replica fleet over tensor-parallel groups
and the dryrun legs. Imports torch, numpy and the port only (never JAX);
called as ``"dist_model_bodies:body_x"`` through ``dist_ranks.run_ranks``.
Each body takes the parent's ``inputs`` dict and returns numpy arrays,
numbers and dicts of them.
"""
from __future__ import annotations

import numpy as np


def _npy(t):
    t = getattr(t, "_value", t)
    return t.detach().float().cpu().numpy().copy()


def _me():
    from paddle_tpu_torch.distributed import env

    return env.get_rank(), env.get_world_size()


def _cpu():
    import paddle_tpu_torch as P

    P.set_device("cpu")
    return P


def _no_hybrid():
    """Leave no fleet hybrid group behind for the bodies after this one."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.base import (
        set_hybrid_communicate_group,
    )

    set_hybrid_communicate_group(None)
    fleet.fleet_api.fleet_obj._hcg = None


# ------------------------------------------------------------ SyncBatchNorm
def bn_net(P):
    """The SyncBatchNorm test's conv net, on either package (``P`` is
    ``paddle_tpu`` or ``paddle_tpu_torch``)."""
    nn = P.nn
    return nn.Sequential(
        nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4), nn.ReLU(),
        nn.Conv2D(4, 4, 3, padding=1), nn.BatchNorm2D(4), nn.ReLU(),
        nn.Flatten(), nn.Linear(4 * 6 * 6, 3))


def _bn_case(P, state, x, y, convert):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import from_paddle_tpu_state

    net = from_paddle_tpu_state(state, bn_net(P))
    if convert:
        net = P.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    kinds = [type(m).__name__ for m in net.sublayers()]
    dp = dist.DataParallel(net)
    out = dp(P.to_tensor(x))
    loss = ((out - P.to_tensor(y)) ** 2).mean()
    loss.backward()
    sd = net.state_dict()
    return {"out": out.numpy(), "kinds": kinds,
            "grads": {k: p.grad.numpy() for k, p in net.named_parameters()},
            "stats": {k: _npy(v) for k, v in sd.items()
                      if k.endswith(("_mean", "_variance"))}}


def body_sync_batchnorm(inputs):
    """Each rank its half of the batch through the converted net (and the
    control: the unconverted one; and the converted net of
    ``offset_state``) under DataParallel: outputs, running statistics and
    the synced gradients."""
    P = _cpu()
    rank, world = _me()
    half = inputs["x"].shape[0] // world
    rows = slice(rank * half, (rank + 1) * half)
    x, y = inputs["x"][rows], inputs["y"][rows]
    out = {"sync": _bn_case(P, inputs["state"], x, y, True),
           "plain": _bn_case(P, inputs["state"], x, y, False),
           "sync_offset": _bn_case(P, inputs["offset_state"], x, y, True)}
    # convert keeps the parameters and buffers themselves
    net = P.nn.Sequential(P.nn.Conv2D(3, 4, 3), P.nn.BatchNorm2D(4))
    w, mean = net[1].weight._value, net[1]._mean
    conv = P.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    out["same_tensors"] = (conv[1].weight._value is w
                           and conv[1]._mean is mean
                           and type(conv[1]).__name__ == "SyncBatchNorm")
    return out


# ------------------------------------------------------ expert parallelism
def _world_group():
    from paddle_tpu_torch.distributed.collective import _world

    return _world()


def body_global_scatter(inputs):
    """The JAX test's exchange (``tests/test_moe.py:144``) over the world:
    rank r holds rows block r of the rank-major buffer; scatter, then
    gather back; and the gradient of the exchange (its own transpose)."""
    import torch

    from paddle_tpu_torch.distributed.utils import (
        global_gather, global_scatter,
    )

    rank, world = _me()
    g = _world_group()
    x = torch.as_tensor(inputs["a2a"])
    mine = x.chunk(world)[rank].clone().requires_grad_(True)
    s = global_scatter(mine, group=g)
    back = global_gather(s, group=g)
    (s * torch.arange(s.numel()).reshape(s.shape)).sum().backward()
    return {"scattered": _npy(s), "back": _npy(back), "grad": _npy(mine.grad),
            "identity": global_scatter(mine.detach()) is not None}


def moe_experts(P, D, E, hidden, state=None, prefix="moe.experts"):
    """E uniform experts (Linear, GELU, Linear) on ``P``, loaded from
    ``state`` (the JAX model's names) when given."""
    nn = P.nn
    out = []
    for i in range(E):
        e = nn.Sequential(nn.Linear(D, hidden), nn.GELU(),
                          nn.Linear(hidden, D))
        if state is not None:
            e.set_state_dict({k: P.to_tensor(state[f"{prefix}.{i}.{k}"])
                              for k in e.state_dict()})
        out.append(e)
    return out


def moe_model(P, D, E, gate="gshard", experts=None):
    """``__graft_entry__.py``'s ``_dryrun_ep`` model on ``P``: a linear
    in, an MoE layer of E experts, a linear out to 4 classes."""
    from importlib import import_module

    nn = P.nn
    moe = import_module(P.__name__ + ".incubate.distributed.models.moe")

    class MoEModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.inp = nn.Linear(D, D)
            self.moe = moe.MoELayer(
                D, experts if experts is not None
                else moe_experts(P, D, E, 2 * D), gate=gate)
            self.out = nn.Linear(D, 4)

        def forward(self, x):
            return self.out(self.moe(self.inp(x)))

    return MoEModel()


def _load_moe(P, D, E, state, gate="gshard"):
    """This rank's part of the JAX MoE model: the whole state loaded, the
    experts before the layer keeps its slice."""
    model = moe_model(P, D, E, gate=gate,
                      experts=moe_experts(P, D, E, 2 * D, state))
    sd = {k: P.to_tensor(state[k]) for k in model.state_dict()
          if not k.startswith("moe.experts.")}
    missing, _ = model.set_state_dict(sd) or ([], [])
    return model


def _global_params(model):
    """{JAX name: array} of this rank's parameters, local experts under
    their global index."""
    lay = model.moe
    n_local = len(lay.experts)
    first = 0 if lay.ep_group is None else lay.ep_group.rank * n_local
    out = {}
    for k, p in model.named_parameters():
        if k.startswith("moe.experts."):
            i, rest = k[len("moe.experts."):].split(".", 1)
            k = f"moe.experts.{first + int(i)}.{rest}"
        out[k] = p.numpy().copy()
    return out


def _ep_train(P, inputs, mesh_shape, strip_expert_groups=False,
              case="ep_case"):
    """[dp, ep] mesh: each rank its rows of ``inputs[case]``'s batch (an
    equal part, or the case's ``sizes[rank]`` rows in rank order) through
    DataParallel (the world) and a TrainStep of AdamW with the gshard
    loss, ``steps`` steps: per-step losses, dropped tokens, the rows
    taken and the parameters after."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.jit import TrainStep

    rank, world = _me()
    C = inputs[case]
    mesh = dist.ProcessMesh(np.arange(world).reshape(mesh_shape),
                            ["dp", "ep"])
    dist.set_mesh(mesh)
    try:
        model = _load_moe(P, C["D"], C["E"], C["state"])
    finally:
        dist.set_mesh(None)
    if strip_expert_groups:
        for p in model.parameters():
            p._value._expert_group = None
    net = dist.DataParallel(model)
    opt = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    lf = P.nn.CrossEntropyLoss()

    def loss_fn(out, y):
        return lf(out, y) + model.moe.gate.get_loss(clear=False)

    step = TrainStep(net, loss_fn, opt)
    sizes = C.get("sizes") or [C["x"].shape[0] // world] * world
    lo = sum(sizes[:rank])
    rows = slice(lo, lo + sizes[rank])
    x, y = P.to_tensor(C["x"][rows]), P.to_tensor(C["y"][rows])
    losses, dropped = [], []
    for _ in range(C["steps"]):
        losses.append(float(step(x, y)))
        dropped.append(int(model.moe.dropped))
    return {"losses": losses, "dropped": dropped, "rows": sizes[rank],
            "params": _global_params(model),
            "n_local": len(model.moe.experts)}


def body_expert_parallel(inputs):
    """The mesh bodies of ``tests/test_moe.py``: ``[dp 1, ep 8]`` with the
    scale experts (every rank the whole batch, as GSPMD replicates it at
    dp 1), then ``[dp 2, ep 4]`` TrainSteps against JAX's whole-batch run
    (and the control that syncs expert gradients over the world, and a
    batch split unevenly), a capacity that binds, and the hybrid clip's
    norm across ep."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet import HybridParallelClipGrad
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    P = _cpu()
    rank, world = _me()
    out = {}
    # [dp 1, ep 8]: the scale experts of the JAX test
    S = inputs["scale_case"]
    mesh = dist.ProcessMesh(np.arange(world).reshape(1, world), ["dp", "ep"])
    dist.set_mesh(mesh)
    try:
        experts = []
        for i in range(world):
            e = P.nn.Linear(S["D"], S["D"])
            with torch.no_grad():
                e.weight._value.copy_(torch.eye(S["D"]) * (i + 1))
                e.bias._value.zero_()
            experts.append(e)
        lay = MoELayer(S["D"], experts, gate="gshard")
    finally:
        dist.set_mesh(None)
    with torch.no_grad():
        lay.gate.weight._value.copy_(torch.as_tensor(S["gate_w"]))
    y = lay(P.to_tensor(S["x"]))
    out["scale"] = {"out": y.numpy(), "n_local": len(lay.experts),
                    "dropped": int(lay.dropped), "l_aux": float(lay.l_aux)}
    # E % ep != 0 raises (3 experts over the 8-rank world group)
    try:
        MoELayer(S["D"], experts[:3], gate="gshard",
                 moe_group=_world_group())
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    # [dp 2, ep 4] against JAX, and the control
    out["train"] = _ep_train(P, inputs, (2, world // 2))
    out["control"] = _ep_train(P, inputs, (2, world // 2),
                               strip_expert_groups=True)
    # a batch split unevenly over the ranks
    out["uneven"] = _ep_train(P, inputs, (2, world // 2),
                              case="uneven_case")
    # a capacity that binds: each rank's output is JAX's single-device
    # layer on the rank's rows
    B = inputs["bind_case"]
    mesh = dist.ProcessMesh(np.arange(world).reshape(2, world // 2),
                            ["dp", "ep"])
    dist.set_mesh(mesh)
    try:
        from paddle_tpu_torch.incubate.distributed.models.moe import (
            GShardGate,
        )

        gate = GShardGate(B["D"], B["E"], capacity=(B["factor"], 2.4))
        lay = MoELayer(B["D"], moe_experts(P, B["D"], B["E"], 2 * B["D"],
                                           B["state"], prefix="experts"),
                       gate=gate)
    finally:
        dist.set_mesh(None)
    with torch.no_grad():
        lay.gate.weight._value.copy_(torch.as_tensor(
            B["state"]["gate.weight"]))
    per = B["x"].shape[0] // world
    yb = lay(P.to_tensor(B["x"][rank * per:(rank + 1) * per]))
    out["bind"] = {"out": yb.numpy(), "dropped": int(lay.dropped)}
    # the hybrid clip's global norm across ep: one backward through
    # DataParallel, then the norm the clip scales by
    mesh = dist.ProcessMesh(np.arange(world).reshape(2, world // 2),
                            ["dp", "ep"])
    C = inputs["ep_case"]
    dist.set_mesh(mesh)
    try:
        model = _load_moe(P, C["D"], C["E"], C["state"])
    finally:
        dist.set_mesh(None)
    net = dist.DataParallel(model)
    per = C["x"].shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    o = net(P.to_tensor(C["x"][rows]))
    (P.nn.CrossEntropyLoss()(o, P.to_tensor(C["y"][rows]))
     + model.moe.gate.get_loss(clear=False)).backward()
    params = [p._value for p in model.parameters()]
    grads = [p.grad._value if hasattr(p.grad, "_value") else p.grad
             for p in model.parameters()]
    clip = HybridParallelClipGrad(ClipGradByGlobalNorm(1e-3))
    clipped = clip.clip_params(params, grads)
    k = max(range(len(grads)), key=lambda i: float(grads[i].abs().max()))
    out["clip_norm"] = float(1e-3 * grads[k].abs().max()
                             / clipped[k].abs().max())
    return out


# ------------------------------------------- tensor-parallel LLaMA and BERT
def _hybrid(dp, mp):
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(dp_degree=dp, mp_degree=mp)
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def _tp_train(P, case, model_fn):
    """fleet.init(dp 2, mp 2): this rank's shards from the whole state,
    its dp half of the batch, 3 TrainStep steps of AdamW through fleet's
    model and optimizer; the losses averaged over dp."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import from_paddle_tpu_state
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep

    hcg = _hybrid(2, 2)
    model = from_paddle_tpu_state(case["state"], model_fn(case["config"]),
                                  device="cpu")
    d = hcg.get_data_parallel_rank()
    half = case["ids"].shape[0] // 2
    ids = torch.as_tensor(case["ids"][d * half:(d + 1) * half])
    labels = torch.as_tensor(case["labels"][d * half:(d + 1) * half])
    out = {"tp": model.tp_group.nranks,
           "local_vocab": int(model(ids).shape[-1])}
    tmodel = fleet.distributed_model(model)
    hopt = fleet.distributed_optimizer(
        popt.AdamW(learning_rate=1e-3, parameters=model.parameters()))
    step = TrainStep(tmodel, lambda logits, loss: loss, hopt)
    losses = []
    for _ in range(3):
        loss = step(ids, labels).detach().clone()
        dist.all_reduce(loss, op="avg", group=hcg.get_data_parallel_group())
        losses.append(float(loss))
    out["losses"] = losses
    _no_hybrid()
    return out


def body_tp_training(inputs):
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.models.llama import LlamaConfig

    P = _cpu()
    return {"llama": _tp_train(P, inputs["llama_train"],
                               lambda c: LlamaConfig(**c)),
            "bert": _tp_train(P, inputs["bert_train"],
                              lambda c: BertConfig(**c))}


def _gpt_over_tp(case):
    from paddle_tpu_torch import from_paddle_tpu_state
    from paddle_tpu_torch.models.gpt import GPTConfig

    model = from_paddle_tpu_state(case["state"], GPTConfig(**case["config"]),
                                  device="cpu")
    model.eval()
    return model


def _f32_pool(model, case):
    """A pool over the model's tensor-parallel group (the serving mesh's
    "tp" axis) of the case's shape and dtype."""
    from paddle_tpu_torch.inference import PagedKVCache

    L, Hkv, D = model._decode_cache_spec()
    return PagedKVCache(L, Hkv, D, device="cpu", **case["pool"])


def _mixed_requests(pred, requests):
    """The requests ``[(prompt, adapter)]`` from threads, in order."""
    import threading

    outs = [None] * len(requests)

    def one(i):
        p, a = requests[i]
        outs[i] = np.asarray(pred.infer(p, timeout=300, adapter=a))

    ts = [threading.Thread(target=one, args=(i,))
          for i in range(len(requests))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return outs


def body_tp_serving(inputs):
    """serving_mesh(dp 2, tp 2): each pair of ranks a tensor-parallel
    group. LLaMA's greedy generate_paged on the head-sharded pool; the
    continuous scheduler with two LoRA adapters (mixed requests, an
    unload and a reload mirrored to the follower); the self-drafter's
    speculative scheduler."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import from_paddle_tpu_state
    from paddle_tpu_torch.inference import AdapterRegistry
    from paddle_tpu_torch.inference.scheduler import (
        ContinuousGenerateBatchingPredictor,
    )
    from paddle_tpu_torch.inference.speculative import (
        SelfSpeculativeDrafter,
    )
    from paddle_tpu_torch.models.llama import LlamaConfig

    import dist_ranks

    _cpu()
    rank, _ = _me()
    dist.serving_mesh(dp=2, tp=2)
    out = {}
    try:
        L = inputs["llama_serve"]
        model = from_paddle_tpu_state(L["state"], LlamaConfig(**L["config"]),
                                      device="cpu")
        model.eval()
        toks, cache = dist_ranks._paged_tokens(model, L["prompts"], L["new"])
        out["llama"] = {"tokens": toks, "tp": model.tp_group.nranks,
                        "pool": tuple(cache.k_pages[0].shape),
                        "ratio": cache.per_chip_pool_bytes()
                        / cache.pool_bytes()}
        # LoRA at tp 2: every rank its registry over its shards; the
        # leader loads, serves, unloads and reloads
        R = inputs["lora"]
        model = _gpt_over_tp(R)
        reg = AdapterRegistry(model, max_adapters=2, max_rank=8,
                              targets=R["targets"])
        pred = ContinuousGenerateBatchingPredictor(
            model, adapters=reg, device="cpu", kv_cache=_f32_pool(model, R),
            **R["sched_kw"])
        leader = model.tp_group.rank == 0
        lora = {"dims": {p: reg.dims(p) for p in reg.target_paths()}}
        if leader:
            for name, w in R["weights"].items():
                reg.register(name, w, alpha=R["alpha"])
            lora["tokens"] = _mixed_requests(pred, R["requests"])
            reg.unregister("a1")
            reg.register("a1", R["weights"]["a1"], alpha=R["alpha"])
            lora["again"] = _mixed_requests(pred, R["requests"][:3])
        pred.close()
        lora["names"] = reg.names()
        lora["bank"] = {p: (_npy(reg.bank()["a"][p]), _npy(reg.bank()["b"][p]))
                        for p in reg.target_paths()}
        reg.close()
        out["lora"] = lora
        # the self-drafter at tp 2 (f32 drafts)
        S = inputs["spec"]
        model = _gpt_over_tp(S)
        pred = ContinuousGenerateBatchingPredictor(
            model, drafter=SelfSpeculativeDrafter(model, dtype=None),
            device="cpu", kv_cache=_f32_pool(model, S), **S["sched_kw"])
        spec = {}
        if model.tp_group.rank == 0:
            spec["tokens"] = [np.asarray(pred.infer(p, timeout=300))
                              for p in S["prompts"]]
            spec["drafted"] = pred._spec_drafted
            spec["accepted"] = pred._spec_accepted
        pred.close()
        if model.tp_group.rank != 0:
            spec["follower_runs"] = pred.follower_runs
        out["spec"] = spec
    finally:
        dist.set_mesh(None)
    out["rank"] = rank
    return out


# ------------------------------------------------ the fleet over tp groups
def body_serving_tp(inputs):
    """``__graft_entry__.py``'s ``_dryrun_serving_tp`` over four ranks:
    ``serving_mesh(dp=2, tp=2)``, a ``ReplicaFleet`` of two lockstep
    groups built on every rank, the router on rank 0 serving 8 threaded
    requests; each replica's pool bytes per rank and its state."""
    import threading

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.inference.serving import ReplicaFleet

    rank, _ = _me()
    F = inputs["fleet"]
    dist.serving_mesh(dp=2, tp=2)
    out = {}
    try:
        model = _gpt_over_tp(F)
        fleet = ReplicaFleet.build(model, n_replicas=2, device="cpu",
                                   kv_cache=_f32_pool(model, F),
                                   **F["sched_kw"])
        if rank == 0:
            outs = [None] * len(F["prompts"])

            def one(i):
                outs[i] = np.asarray(fleet.infer(
                    F["prompts"][i], timeout=300,
                    max_new_tokens=F["wants"][i]))

            ts = [threading.Thread(target=one, args=(i,))
                  for i in range(len(outs))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            out["tokens"] = outs
            out["pools"] = [
                (rep.predictor.kv_cache.tp_sharded,
                 rep.predictor.kv_cache.per_chip_pool_bytes(),
                 rep.predictor.kv_cache.pool_bytes())
                for rep in fleet._replicas]
            out["states"] = fleet.replica_states()
            out["kinds"] = [type(rep.predictor).__name__
                            for rep in fleet._replicas]
            # retire the remote replica (drain, wait, close over rpc):
            # it reads dead, and the router serves from the other
            fleet.retire_replica("r1", drain_timeout=5.0)
            out["after_retire"] = fleet.replica_states()
            out["after_retire_tokens"] = np.asarray(fleet.infer(
                F["prompts"][0], timeout=300, max_new_tokens=F["wants"][0]))
        else:
            try:
                fleet.infer(F["prompts"][0])
                out["refuses"] = False
            except RuntimeError:
                out["refuses"] = True
        fleet.close()
        out["comms"] = _decode_comms()
    finally:
        dist.set_mesh(None)
    return out


def _decode_comms():
    """``__graft_entry__.py:486-501``: the decode step's comms report,
    traced at tp 2 over this job's real gloo ranks (every rank enters:
    ``tp_world`` makes the mesh's groups, a collective act)."""
    from paddle_tpu_torch.analysis.comms import (analyze_step_comms,
                                                 step_comms_surfaces)

    surfaces = step_comms_surfaces(paths=("decode_step",), device="cpu")
    report = analyze_step_comms(paths=("decode_step",), _surfaces=surfaces)
    (s,) = surfaces
    return {"high": [f.render() for f in report.high()],
            "suppressed": [f.rule for f, _e in report.suppressed],
            "ops": [(op.kind, op.result, op.group_size, op.count,
                     op.wire_bytes) for op in s["ops"]],
            "input_specs": s["input_specs"],
            "output_specs": s["output_specs"],
            "mesh_axes": s["mesh_axes"]}


# ------------------------------------------------------------ dryrun legs
def body_pp_hybrid(inputs):
    """``_dryrun_pp_hybrid``: one ``train_batch`` of ``gpt_pipeline(
    gpt_tiny(), 2)`` over ``[pp 2, dp 2, mp 2]``, ZeRO-2, 1F1B, tied
    embeddings shared across the stages."""
    import torch

    import dist_pipeline_bodies as pb
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.bridge import stage_state
    from paddle_tpu_torch.distributed.fleet import PipelineParallel
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_pipeline

    C = inputs["pp_hybrid"]
    s, hcg = pb._hcg(pp=2, dp=2, mp=2, micro=2, zero=2,
                     batch=C["ids"].shape[0])
    cfg = GPTConfig(**C["config"])
    model = gpt_pipeline(cfg, num_stages=2, device="cpu")
    model.set_state_dict(stage_state(C["state"], model))
    wrapper = PipelineParallel(model, hcg, strategy=s)
    opt = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    x = pb.local_rows(C["ids"], hcg, 2)
    y = pb.local_rows(C["labels"], hcg, 2)
    loss = float(wrapper.train_batch((torch.as_tensor(x),
                                      torch.as_tensor(y)), opt))
    _no_hybrid()
    return {"loss": loss, "stage": hcg.get_stage_id(),
            "mp": hcg.get_model_parallel_rank(),
            "keys": sorted(model.state_dict()),
            "tied_group": sorted(model._shared_groups["gpt_embed"].ranks)
            if "gpt_embed" in getattr(model, "_shared_groups", {}) else None}


def body_llama_zero3(inputs):
    """``_dryrun_llama_zero3`` at dp = world: ``llama_tiny()`` under
    ``ShardingStage3`` over a dp mesh, 5 TrainStep steps of AdamW on this
    rank's rows; each stage-3 parameter's local fraction."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import from_paddle_tpu_state
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.distributed.layout import layout_of
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig

    _cpu()
    rank, world = _me()
    Z = inputs["llama_zero3"]
    mesh = dist.auto_mesh(world, dim_names=["dp"])
    dist.set_mesh(mesh)
    try:
        model = from_paddle_tpu_state(Z["state"], LlamaConfig(**Z["config"]),
                                      device="cpu")
        opt = popt.AdamW(learning_rate=1e-3, parameters=model.parameters())
        sopt = dist.shard_optimizer(opt, dist.ShardingStage3("dp", mesh))
        step = TrainStep(model, lambda logits, loss: loss, sopt)
        per = Z["ids"].shape[0] // world
        rows = slice(rank * per, (rank + 1) * per)
        x = torch.as_tensor(Z["ids"][rows])
        y = torch.as_tensor(Z["labels"][rows])
        losses = []
        for _ in range(5):
            loss = step(x, y).detach().clone()
            dist.all_reduce(loss, op="avg")
            losses.append(float(loss))
        fracs = {}
        for k, p in model.named_parameters():
            shape, _ = layout_of(p)
            if shape[0] % world == 0:
                fracs[k] = p.numel() / float(np.prod(shape))
        sharding.uninstall(model)
    finally:
        dist.set_mesh(None)
    return {"losses": losses, "fracs": fracs}


def body_ring_16k(inputs):
    """``_dryrun_ring_16k``: causal ring attention at S 16384 over a sep
    group of the world (B 1, H 2, D 32, f32), each rank its S / world
    positions (the same seeded arrays as JAX's leg); the last rank keeps
    the last position's output."""
    import torch

    from paddle_tpu_torch.distributed.context_parallel import ring_attention

    rank, world = _me()
    R = inputs["ring"]
    S, B, H, D = R["S"], R["B"], R["H"], R["D"]
    rs = np.random.RandomState(R["seed"])
    q = rs.randn(B, S, H, D).astype(np.float32) * 0.1
    k = rs.randn(B, S, H, D).astype(np.float32) * 0.1
    v = rs.randn(B, S, H, D).astype(np.float32) * 0.1
    n = S // world
    cut = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a[:, rank * n:(rank + 1) * n]))
    with torch.no_grad():
        out = ring_attention(cut(q), cut(k), cut(v), group=_world_group(),
                             causal=True)
    return {"shape": tuple(out.shape),
            "last": _npy(out[0, -1]) if rank == world - 1 else None}


def body_ep_dryrun(inputs):
    """``_dryrun_ep``: one TrainStep of the ``[dp 2, ep 4]`` MoE model
    through DataParallel."""
    P = _cpu()
    rank, world = _me()
    return _ep_train(P, {"ep_case": inputs["ep_dryrun"]}, (2, world // 2))
