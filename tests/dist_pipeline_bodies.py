"""Rank bodies of the pipeline, ZeRO, hybrid and checkpoint tests, run by
``dist_ranks.run_ranks(["dist_pipeline_bodies:<body>"], world, inputs)``.
Imports torch, numpy and the port only (never JAX). Every body takes the
whole state under JAX's names (``inputs``), builds its part with
``bridge.stage_state`` and returns numpy arrays and numbers:
``bridge.part_record`` of what it holds, which the tests put back
together with ``bridge.gather_parts``.
"""
from __future__ import annotations

import numpy as np


def _me():
    from paddle_tpu_torch.distributed import env

    return env.get_rank(), env.get_world_size()


def _cpu():
    """The port's layers build on the CPU in the ranks."""
    import paddle_tpu_torch

    paddle_tpu_torch.set_device("cpu")


def _hcg(pp=1, dp=1, mp=1, sharding=1, sep=1, micro=4, schedule="1F1B",
         vpp=1, zero=0, batch=8):
    """A fleet strategy and its hybrid group, installed as fleet's."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.base import (
        set_hybrid_communicate_group,
    )

    _cpu()
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(pp_degree=pp, dp_degree=dp, mp_degree=mp,
                            sharding_degree=sharding, sep_degree=sep)
    if vpp > 1:
        s.hybrid_configs["pp_configs"] = {"virtual_pp_degree": vpp}
    s.pipeline_configs = {"accumulate_steps": micro,
                          "micro_batch_size": batch // micro,
                          "schedule_mode": schedule}
    if zero:
        s.sharding = True
        s.sharding_configs = {"stage": zero}
    hcg = fleet.HybridCommunicateGroup(strategy=s)
    set_hybrid_communicate_group(hcg)
    fleet.fleet_api.fleet_obj._strategy = s
    fleet.fleet_api.fleet_obj._hcg = hcg
    return s, hcg


def local_rows(x, hcg, micro):
    """This rank's rows of a global batch: of each micro-batch, the block
    of its (dp, sharding) coordinate (JAX shards each micro-batch over
    ("dp", "sharding"), row-major, dropping "sharding" when the product
    does not divide the rows: ``StagePlacement.act_spec``)."""
    mbs = np.split(np.asarray(x), micro)
    ns = hcg.get_sharding_parallel_world_size()
    nd = hcg.get_data_parallel_world_size() * ns
    d = hcg.get_data_parallel_rank() * ns + hcg.get_sharding_parallel_rank()
    if mbs[0].shape[0] % nd:
        nd, d = hcg.get_data_parallel_world_size(), \
            hcg.get_data_parallel_rank()
    parts = []
    for mb in mbs:
        parts.append(np.split(mb, nd)[d])
    return np.concatenate(parts)


def _loss_mse(out, label):
    return ((out - label) ** 2).mean()


def _linear_descs(n, hid):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet import LayerDesc

    return [LayerDesc(nn.Linear, hid, hid) for _ in range(n)]


def _mlp_block_cls(hid):
    """JAX's ``_MLPBlock`` (tests/test_hybrid_parallel.py): a column- then
    row-parallel pair over the hybrid group's mp axis."""
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear,
        RowParallelLinear,
    )

    class MLPBlock(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up = ColumnParallelLinear(hid, hid * 2, gather_output=False,
                                           device="cpu")
            self.down = RowParallelLinear(hid * 2, hid,
                                          input_is_parallel=True,
                                          device="cpu")

        def forward(self, x):
            return self.down(torch.relu(self.up(x)))

    return MLPBlock


def _train(wrapper, opt, data, steps, hcg, micro, scaler=None):
    import torch

    losses = []
    for step in range(steps):
        x, y = data(step)
        if hcg is not None:
            x, y = local_rows(x, hcg, micro), local_rows(y, hcg, micro)
        losses.append(float(wrapper.train_batch(
            (torch.as_tensor(x), torch.as_tensor(y)), opt, scaler=scaler)))
    return losses


def _mse_data(seed0, batch, hid):
    def data(step):
        rs = np.random.RandomState(seed0 + step)
        return (rs.randn(batch, hid).astype("float32"),
                rs.randn(batch, hid).astype("float32"))
    return data


def _run_stack(inputs, pp, dp, vpp=1, schedule="1F1B", steps=10, mp=0,
               micro=None):
    """JAX's Linear-stack pipeline run (test_pipeline_parallel.py) on this
    rank's stage."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.bridge import part_record, stage_state
    from paddle_tpu_torch.distributed.fleet import (
        PipelineLayer,
        PipelineParallel,
        PipelineParallelWithInterleave,
    )

    batch, hid = inputs["batch"], inputs["hid"]
    micro = micro or inputs["micro"]
    s, hcg = _hcg(pp=pp, dp=dp, micro=micro, schedule=schedule, vpp=vpp,
                  batch=batch)
    model = PipelineLayer(_linear_descs(inputs["n_layers"], hid),
                          num_stages=pp, loss_fn=_loss_mse,
                          num_virtual_pipeline_stages=vpp)
    model.set_state_dict(stage_state(inputs["stack_state"], model))
    cls = PipelineParallelWithInterleave if vpp > 1 else PipelineParallel
    wrapper = cls(model, hcg, strategy=s)
    opt = optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    losses = _train(wrapper, opt, _mse_data(0, batch, hid), steps, hcg,
                    micro)
    return {"losses": losses, "params": part_record(model),
            "stage": hcg.get_stage_id(), "dp": hcg.get_data_parallel_rank(),
            "keys": sorted(model.state_dict()),
            "chunks": sorted(wrapper._engine.chunks),
            "schedule": wrapper._engine.schedule, "syncs": wrapper.syncs,
            "sent": wrapper._engine.sent,
            "held_peak": wrapper._engine.held_peak}


def body_pp4(inputs):
    return _run_stack(inputs, pp=4, dp=1)


def body_pp4_m8(inputs):
    """The stack at pp 4 over 8 micro-batches of one row: more
    micro-batches than stages."""
    return _run_stack(inputs, pp=4, dp=1, micro=8, steps=2)


def body_pp2_dp2(inputs):
    return _run_stack(inputs, pp=2, dp=2)


def body_vpp2(inputs):
    return _run_stack(inputs, pp=2, dp=2, vpp=2)


def body_shared(inputs):
    """JAX's tied-Linear model (a SharedLayerDesc at both ends) over pp 2
    x dp 2, 3 steps."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.bridge import part_record, stage_state
    from paddle_tpu_torch.distributed.fleet import (
        LayerDesc,
        PipelineLayer,
        PipelineParallel,
        SharedLayerDesc,
    )

    hid, micro = inputs["hid"], inputs["micro"]
    s, hcg = _hcg(pp=2, dp=2, micro=micro, batch=inputs["batch"])
    descs = [
        SharedLayerDesc("tied", nn.Linear, None, "weight", hid, hid),
        LayerDesc(nn.Linear, hid, hid),
        LayerDesc(nn.Linear, hid, hid),
        SharedLayerDesc("tied", nn.Linear, None, "weight", hid, hid),
    ]
    model = PipelineLayer(descs, num_stages=2, loss_fn=_loss_mse)
    model.set_state_dict(stage_state(inputs["shared_state"], model))
    wrapper = PipelineParallel(model, hcg, strategy=s)
    opt = optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    losses = _train(wrapper, opt, _mse_data(0, inputs["batch"], hid), 3,
                    hcg, micro)
    return {"losses": losses, "params": part_record(model),
            "keys": sorted(model.state_dict()),
            "shared_group": (sorted(model._shared_groups["tied"].ranks)
                             if "tied" in model._shared_groups else None)}


def _gpt_run(inputs, key, pp, dp=1, mp=1, plant=None):
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.bridge import part_record, stage_state
    from paddle_tpu_torch.distributed.fleet import PipelineParallel
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_pipeline
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    micro = inputs["micro"]
    s, hcg = _hcg(pp=pp, dp=dp, mp=mp, micro=micro,
                  batch=inputs["gpt_ids"].shape[0])
    cfg = GPTConfig(**inputs[f"{key}_cfg"])
    model = gpt_pipeline(cfg, num_stages=pp, device="cpu")
    model.set_state_dict(stage_state(inputs[f"{key}_state"], model))
    wrapper = PipelineParallel(model, hcg, strategy=s)
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                          weight_decay=0.01,
                          grad_clip=ClipGradByGlobalNorm(inputs["clip"]))
    ids, labels = inputs["gpt_ids"], inputs["gpt_labels"]
    losses = []
    for _ in range(3):
        x = local_rows(ids, hcg, micro)
        y = local_rows(labels, hcg, micro)
        losses.append(float(wrapper.train_batch(
            (torch.as_tensor(x), torch.as_tensor(y)), opt)))
    return {"losses": losses, "params": part_record(model),
            "stage": hcg.get_stage_id(), "mp": hcg.get_model_parallel_rank(),
            "clip": type(opt._grad_clip).__name__}


def body_gpt_tied(inputs):
    return _gpt_run(inputs, "tied", pp=2, dp=2)


def body_gpt_untied_mp(inputs):
    return _gpt_run(inputs, "untied", pp=2, mp=2)


# ------------------------------------------------------------------ ZeRO
def _zero_model(state):
    from paddle_tpu_torch import nn

    model = nn.Sequential(nn.Linear(state["0.weight"].shape[0],
                                    state["0.weight"].shape[1]), nn.GELU(),
                          nn.Linear(state["2.weight"].shape[0],
                                    state["2.weight"].shape[1]))
    model.set_state_dict(state)
    return model


def _zero_step(inputs, stage, eager=False, data_parallel=False):
    """``steps`` AdamW steps of the ZeRO model on this rank's rows under
    ``ShardingStage{stage}`` over a dp mesh of the world: through
    TrainStep (or the eager ``_ShardOptimizer.step``)."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.bridge import part_record
    from paddle_tpu_torch.jit import TrainStep

    _cpu()
    rank, world = _me()
    mesh = dist.auto_mesh(world, dim_names=["dp"])
    dist.set_mesh(mesh)
    model = _zero_model(inputs["zero_state"])
    opt = optimizer.AdamW(learning_rate=1e-2, parameters=model.parameters())
    stage_cls = {1: dist.ShardingStage1, 2: dist.ShardingStage2,
                 3: dist.ShardingStage3}[stage]
    zero = stage_cls("dp", mesh)
    sopt = dist.shard_optimizer(opt, zero)
    from paddle_tpu_torch.distributed import sharding

    hook_at_bind = sharding._HOOK["handle"] is not None
    net = dist.DataParallel(model) if data_parallel else model
    x = torch.as_tensor(np.split(inputs["zero_x"], world)[rank])
    y = torch.as_tensor(np.split(inputs["zero_y"], world)[rank])
    loss_fn = nn.MSELoss()
    losses = []
    # stage 3 under TrainStep: count the gathered weights the backward
    # kept that were dropped after the forward and gathered again
    regathered = [0]
    init_regather = sharding._Regather.__init__

    def counting(self, *a):
        regathered[0] += 1
        init_regather(self, *a)

    sharding._Regather.__init__ = counting
    if eager:
        for _ in range(inputs["zero_steps"]):
            loss = loss_fn(net(x), y)
            loss.backward()
            sopt.step()
            sopt.clear_grad()
            losses.append(float(loss))
    else:
        step = TrainStep(net, lambda o, t: loss_fn(o, t), sopt)
        losses = [float(step(x, y)) for _ in range(inputs["zero_steps"])]
    sharding._Regather.__init__ = init_regather
    accs = {name: {k: tuple(t.shape) for k, t in zip(
        [n for n, _ in model.named_parameters()],
        [store.get(id(p._value)) for _, p in model.named_parameters()])
        if t is not None} for name, store in opt._accumulators.items()}
    out = {"losses": losses, "params": part_record(model),
           "param_shapes": {k: tuple(p.shape) for k, p in
                            model.named_parameters()},
           "acc_shapes": accs,
           "grad_shapes": {n: tuple(zero.local_grads[id(p._value)].shape)
                           for n, p in model.named_parameters()
                           if id(p._value) in zero.local_grads},
           "opt_state": part_record(model, {
               k: v for k, v in _acc_by_name(opt, model, "moment1").items()}),
           "clip": type(opt._grad_clip).__name__ if opt._grad_clip else None,
           "regathered": regathered[0]}
    if data_parallel:
        out["dp_syncs"] = net.syncs

    def swapped():
        return sorted(type(m)._zero3_base.__name__ for m in model.modules()
                      if hasattr(type(m), "_zero3_base"))

    from torch.nn.modules import module as torch_module

    out.update(hook_at_bind=hook_at_bind, swapped=swapped(),
               hooks_left=len(torch_module._global_forward_pre_hooks))
    sharding.uninstall(model)
    out["swapped_after_uninstall"] = swapped()
    dist.set_mesh(None)
    return out


def _acc_by_name(opt, model, acc):
    store = opt._accumulators.get(acc, {})
    return {n: store[id(p._value)] for n, p in model.named_parameters()
            if id(p._value) in store}


def body_zero1(inputs):
    return _zero_step(inputs, 1)


def body_zero2(inputs):
    return _zero_step(inputs, 2)


def body_zero3(inputs):
    return _zero_step(inputs, 3)


def body_zero2_eager(inputs):
    return _zero_step(inputs, 2, eager=True)


def body_zero3_eager(inputs):
    return _zero_step(inputs, 3, eager=True)


def body_zero1_data_parallel(inputs):
    return _zero_step(inputs, 1, data_parallel=True)


def body_zero_scaler(inputs):
    """A GradScaler under ``shard_scaler`` over ZeRO-2: the last rank's
    loss is infinite, so every rank skips its step and halves its scale."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import nn, optimizer

    _cpu()
    rank, world = _me()
    mesh = dist.auto_mesh(world, dim_names=["dp"])
    dist.set_mesh(mesh)
    model = _zero_model(inputs["zero_state"])
    before = {k: p._value.detach().clone()
              for k, p in model.named_parameters()}
    opt = dist.shard_optimizer(
        optimizer.AdamW(learning_rate=1e-2, parameters=model.parameters()),
        dist.ShardingStage2("dp", mesh))
    scaler = dist.shard_scaler(amp.GradScaler(init_loss_scaling=1024.0))
    x = torch.as_tensor(np.split(inputs["zero_x"], world)[rank])
    y = torch.as_tensor(np.split(inputs["zero_y"], world)[rank])
    loss = nn.MSELoss()(model(x), y)
    if rank == world - 1:
        loss = loss * float("inf")
    scaler.scale(loss).backward()
    scaler.step(opt)
    opt.clear_grad()
    unchanged = all(torch.equal(p._value, before[k])
                    for k, p in model.named_parameters())
    # a clean step after it: every rank steps
    loss = nn.MSELoss()(model(x), y)
    scaler.scale(loss).backward()
    scaler.step(opt)
    moved = any(not torch.equal(p._value, before[k])
                for k, p in model.named_parameters())
    dist.set_mesh(None)
    return {"unchanged": unchanged, "scale": scaler._scale, "moved": moved}


# ---------------------------------------------------------------- hybrid
def _hybrid(inputs, pp, dp, mp, sharding, zero, clip=None):
    """JAX's ``_run_hybrid`` (tests/test_hybrid_parallel.py) on this
    rank: PipelineParallel over the strategy's (pp, dp, mp, sharding) with
    ZeRO from ``sharding_configs``, SGD, 6 steps."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.bridge import part_record, stage_state
    from paddle_tpu_torch.distributed.fleet import (
        LayerDesc,
        PipelineLayer,
        PipelineParallel,
    )
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    hid, micro = inputs["hid"], inputs["micro"]
    s, hcg = _hcg(pp=pp, dp=dp, mp=mp, sharding=sharding, zero=zero,
                  micro=micro, batch=inputs["batch"])
    block = _mlp_block_cls(hid)
    model = PipelineLayer([LayerDesc(block) for _ in range(
        inputs["n_blocks"])], num_stages=pp, loss_fn=_loss_mse)
    model.set_state_dict(stage_state(inputs["hybrid_state"], model))
    wrapper = PipelineParallel(model, hcg, strategy=s)
    opt = optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    losses = _train(wrapper, opt, _mse_data(100, inputs["batch"], hid),
                    inputs["steps"], hcg, micro)
    zero_stage = wrapper._zero
    names = {id(getattr(p, "_value", p)): k
             for k, p in model.state_dict().items()}
    out = {"losses": losses, "params": part_record(model),
           "coord": (hcg.get_stage_id(), hcg.get_data_parallel_rank(),
                     hcg.get_sharding_parallel_rank(),
                     hcg.get_model_parallel_rank()),
           "shapes": {k: tuple(getattr(p, "_value", p).shape)
                      for k, p in model.state_dict().items()},
           "clip": type(opt._grad_clip).__name__ if clip else None}
    if zero_stage is not None:
        out["zero_axis"] = zero_stage.axis_name
        out["grad_shapes"] = {names[i]: tuple(g.shape) for i, g in
                              zero_stage.local_grads.items() if i in names}
    return out


def body_hybrid_pp_dp_mp(inputs):
    return _hybrid(inputs, 2, 2, 2, 1, 0)


def body_hybrid_pp_mp_zero2(inputs):
    return _hybrid(inputs, 2, 1, 2, 2, 2)


def body_hybrid_pp_dp_zero3(inputs):
    return _hybrid(inputs, 2, 2, 1, 2, 3)


def body_hybrid_clip(inputs):
    return _hybrid(inputs, 2, 1, 2, 2, 2, clip=inputs["clip"])


# ------------------------------------------------------------- schedules
def _block_layer_cls(hid):
    """JAX's ``_Block`` (tests/test_pipeline_schedules.py) on the port's
    nn."""
    from paddle_tpu_torch import nn

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.up = nn.Linear(hid, hid * 2)
            self.down = nn.Linear(hid * 2, hid)

        def forward(self, x):
            return self.down(nn.functional.relu(self.up(x)))

    return Block


def body_schedules(inputs):
    """Every schedule (and VPP 2) over pp 2 x dp 2, 5 SGD steps each from
    the same weights."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.bridge import stage_state
    from paddle_tpu_torch.distributed.fleet import (
        LayerDesc,
        PipelineLayer,
        PipelineParallel,
    )

    hid, micro = inputs["hid"], inputs["micro"]
    block = _block_layer_cls(hid)
    out = {}
    for name, sched, vpp in inputs["schedules"]:
        s, hcg = _hcg(pp=2, dp=2, micro=micro, schedule=sched, vpp=vpp,
                      batch=inputs["batch"])
        model = PipelineLayer([LayerDesc(block) for _ in range(
            inputs["n_blocks"])], num_stages=2, loss_fn=_loss_mse,
            num_virtual_pipeline_stages=vpp)
        model.set_state_dict(stage_state(inputs["sched_state"], model))
        wrapper = PipelineParallel(model, hcg, strategy=s)
        opt = optimizer.SGD(learning_rate=0.1,
                            parameters=model.parameters())
        losses = _train(wrapper, opt, _mse_data(100, inputs["batch"], hid),
                        inputs["steps"], hcg, micro)
        out[name] = {"losses": losses, "schedule": wrapper._engine.schedule,
                     "chunks": sorted(wrapper._engine.chunks)}
    return out


def body_fleet_schedule_mode(inputs):
    """``schedule_mode`` through fleet.init and distributed_model."""
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import LayerDesc, PipelineLayer

    _cpu()
    hid, micro = inputs["hid"], inputs["micro"]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(pp_degree=2, dp_degree=2, mp_degree=1)
    strategy.pipeline_configs = {"accumulate_steps": micro,
                                 "micro_batch_size": inputs["batch"] // micro,
                                 "schedule_mode": "zero_bubble"}
    fleet.init(is_collective=True, strategy=strategy)
    block = _block_layer_cls(hid)
    model = PipelineLayer([LayerDesc(block) for _ in range(
        inputs["n_blocks"])], num_stages=2, loss_fn=_loss_mse)
    wrapper = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters()))
    hcg = fleet.get_hybrid_communicate_group()
    x, y = _mse_data(100, inputs["batch"], hid)(0)
    loss = wrapper.train_batch((torch.as_tensor(local_rows(x, hcg, micro)),
                                torch.as_tensor(local_rows(y, hcg, micro))),
                               opt)
    return {"wrapper": type(wrapper).__name__,
            "schedule": wrapper._engine.schedule, "loss": float(loss),
            "mode": hcg.get_parallel_mode()}


# ------------------------------------------------------------ checkpoint
def body_ckpt_reshard(inputs):
    """JAX's test_save_then_reshard_load_roundtrip on a (2, 2) mesh of the
    4 ranks: saved under placements A, loaded on the transposed mesh under
    placements B; each rank's part equals its part of the whole."""
    import os

    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import (
        load_state_dict,
        save_state_dict,
    )

    _cpu()
    S, R = dist.Shard, dist.Replicate
    arrays = {k: torch.as_tensor(v) for k, v in inputs["arrays"].items()}
    mesh_a = dist.ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    pa = {"w1": [S(0), S(1)], "w2": [R(), S(1)], "b": [R(), R()]}
    sd = {k: dist.shard_tensor(v, mesh_a, pa[k]) for k, v in arrays.items()}
    path = os.path.join(inputs["dir"], "reshard")
    save_state_dict(sd, path)
    mesh_b = dist.ProcessMesh(np.arange(4).reshape(2, 2).T, ["dp", "mp"])
    pb = {"w1": [S(1), S(0)], "w2": [S(1), R()], "b": [S(0), R()]}
    target = {k: dist.shard_tensor(torch.zeros_like(v), mesh_b, pb[k])
              for k, v in arrays.items()}
    load_state_dict(target, path)
    want = {k: dist.shard_tensor(v, mesh_b, pb[k]) for k, v in arrays.items()}
    rank, _ = _me()
    files = sorted(f for f in os.listdir(path) if f.startswith("data_r"))
    return {"equal": {k: bool(torch.equal(target[k]._value, want[k]._value))
                      for k in arrays},
            "files": files if rank == 0 else None}


def body_ckpt_small(inputs):
    """JAX's nested-dict / scalars, missing-key and async bodies, every
    rank holding the same (replicated) tensors: one rank writes them."""
    import os

    import torch

    from paddle_tpu_torch.distributed.checkpoint import (
        load_state_dict,
        save_state_dict,
    )

    _cpu()
    out = {}
    base = inputs["dir"]
    sd = {"model": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
          "opt": {"lr": 0.125, "step": 7, "name": "adam"}}
    save_state_dict(sd, os.path.join(base, "nested"))
    target = {"model": {"w": torch.zeros(3, 4)},
              "opt": {"lr": 0.0, "step": 0, "name": ""}}
    load_state_dict(target, os.path.join(base, "nested"))
    out["nested"] = (bool(torch.equal(target["model"]["w"],
                                      sd["model"]["w"])), target["opt"])
    out["nested_files"] = sorted(f for f in os.listdir(
        os.path.join(base, "nested")) if f.endswith(".npz"))
    try:
        load_state_dict({"nope": torch.ones(2, 2)},
                        os.path.join(base, "nested"))
        out["missing"] = None
    except KeyError as e:
        out["missing"] = str(e)
    handle = save_state_dict({"w": torch.full((4, 4), 3.0)},
                             os.path.join(base, "async"), async_save=True)
    handle.result(timeout=30)
    from paddle_tpu_torch.distributed import barrier

    barrier()
    tgt = {"w": torch.zeros(4, 4)}
    load_state_dict(tgt, os.path.join(base, "async"))
    out["async"] = float(tgt["w"][0, 0])
    return out


def _ckpt_model(state=None, seed=7):
    import torch

    from paddle_tpu_torch import nn

    torch.manual_seed(seed)
    m = nn.Sequential(nn.Linear(16, 64), nn.ReLU(), nn.Linear(64, 4))
    if state is not None:
        m.set_state_dict(state)
    return m


def _ckpt_step(model, zero, mesh, data_parallel=False):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F

    opt = optimizer.Adam(learning_rate=1e-2, parameters=model.parameters())
    sopt = (dist.shard_optimizer(opt, zero("dp", mesh)) if zero is not None
            else opt)
    net = dist.DataParallel(model) if data_parallel else model
    return opt, TrainStep(net, lambda o, y: F.cross_entropy(o, y), sopt)


def _port_acc(opt, model):
    """{JAX's accumulator name (``tensor_{i}_{acc}``, i the parameter's
    place from 1): the live accumulator}."""
    out = {}
    params = [p._value for _, p in model.named_parameters()]
    for acc in ("moment1", "moment2"):
        for i, p in enumerate(params, 1):
            out[f"tensor_{i}_{acc}"] = opt._accumulators[acc][id(p)]
    return out


def body_ckpt_training(inputs):
    """JAX's resume and ZeRO-3 bodies on the port: (a) train 3 steps
    under ZeRO-3 (rows), save, restore into a fresh DataParallel run
    (whole state) after a desyncing step, continue 3 steps: the losses
    of the uninterrupted DataParallel run; (b) 2 ZeRO-3 steps, save,
    restore into a fresh primed ZeRO-3 step, 2 more: the uninterrupted
    run's. Then (c) a JAX ZeRO-3 checkpoint of 8 devices into ZeRO-1
    here, continued; (d) this rank's ZeRO-3 state written for JAX."""
    import os

    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.bridge import part_record
    from paddle_tpu_torch.distributed.checkpoint import (
        load_state_dict,
        save_state_dict,
    )

    _cpu()
    rank, world = _me()
    mesh = dist.auto_mesh(world, dim_names=["dp"])
    dist.set_mesh(mesh)
    xs = [torch.as_tensor(np.split(x, world)[rank]) for x in inputs["xs"]]
    ys = [torch.as_tensor(np.split(y, world)[rank]) for y in inputs["ys"]]
    init = inputs["ckpt_init"]
    base = inputs["dir"]
    out = {}

    def mean(v):
        t = torch.tensor(float(v))
        dist.all_reduce(t)
        return float(t) / world

    # (a) ZeRO-3 -> DataParallel, across the layouts
    m_ref = _ckpt_model(init)
    _, s_ref = _ckpt_step(m_ref, None, mesh, data_parallel=True)
    ref = [mean(s_ref(x, y)) for x, y in zip(xs, ys)]
    m_a = _ckpt_model(init)
    o_a, s_a = _ckpt_step(m_a, dist.ShardingStage3, mesh)
    first = [mean(s_a(x, y)) for x, y in zip(xs[:3], ys[:3])]
    save_state_dict({"model": m_a.state_dict(), "opt": o_a.state_dict()},
                    os.path.join(base, "resume"))
    m_b = _ckpt_model(init)
    o_b, s_b = _ckpt_step(m_b, None, mesh, data_parallel=True)
    s_b(xs[0], ys[0])                       # desync, and the accumulators
    target = {"model": m_b.state_dict(), "opt": o_b.state_dict()}
    load_state_dict(target, os.path.join(base, "resume"))
    m_b.set_state_dict(target["model"])
    o_b.set_state_dict(target["opt"])
    cont = [mean(s_b(x, y)) for x, y in zip(xs[3:], ys[3:])]
    out["resume"] = (first, cont, ref)

    # (b) ZeRO-3 -> ZeRO-3
    m1 = _ckpt_model(init)
    o1, s1 = _ckpt_step(m1, dist.ShardingStage3, mesh)
    l1 = [mean(s1(x, y)) for x, y in zip(xs[:2], ys[:2])]
    save_state_dict({"model": m1.state_dict(), "opt": o1.state_dict()},
                    os.path.join(base, "z3"))
    m2 = _ckpt_model(init)
    o2, s2 = _ckpt_step(m2, dist.ShardingStage3, mesh)
    s2(xs[0], ys[0])
    target = {"model": m2.state_dict(), "opt": o2.state_dict()}
    load_state_dict(target, os.path.join(base, "z3"))
    m2.set_state_dict(target["model"])
    o2.set_state_dict(target["opt"])
    l2 = [mean(s2(x, y)) for x, y in zip(xs[2:4], ys[2:4])]
    m3 = _ckpt_model(init)
    _, s3 = _ckpt_step(m3, dist.ShardingStage3, mesh)
    r3 = [mean(s3(x, y)) for x, y in zip(xs[:4], ys[:4])]
    out["zero3"] = (l1, l2, r3)

    # (c) JAX's ZeRO-3 checkpoint (8 devices) -> ZeRO-1 on 4 ranks
    m_c = _ckpt_model(init)
    o_c, s_c = _ckpt_step(m_c, dist.ShardingStage1, mesh)
    s_c(xs[0], ys[0])                       # prime the accumulators
    target = {"model": dict(m_c.state_dict()), "opt": _port_acc(o_c, m_c)}
    target["opt"]["@step"] = 0
    load_state_dict(target, inputs["jax_z3"])
    o_c._step_count = int(target["opt"]["@step"])
    out["from_jax"] = [mean(s_c(x, y)) for x, y in zip(xs[2:4], ys[2:4])]
    out["acc_rows"] = tuple(o_c._accumulators["moment1"][
        id(m_c.parameters()[0]._value)].shape)

    # (d) the port's ZeRO-3 state after 2 steps, for JAX to read
    m_d = _ckpt_model(init)
    o_d, s_d = _ckpt_step(m_d, dist.ShardingStage3, mesh)
    for x, y in zip(xs[:2], ys[:2]):
        s_d(x, y)
    save_state_dict({"model": m_d.state_dict(), "opt": _port_acc(o_d, m_d)},
                    os.path.join(base, "port_z3"))
    out["port_z3"] = part_record(m_d)
    out["port_z3_m1"] = part_record(m_d, {
        n: o_d._accumulators["moment1"][id(p._value)]
        for n, p in m_d.named_parameters()})
    out["param_rows"] = tuple(m_d.parameters()[0]._value.shape)

    # bf16 both ways
    bf = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(
        torch.bfloat16) / 7
    save_state_dict({"w": bf}, os.path.join(base, "port_bf16"))
    tgt = {"w": torch.zeros(3, 4, dtype=torch.bfloat16)}
    load_state_dict(tgt, inputs["jax_bf16"])
    out["bf16_from_jax"] = tgt["w"].view(torch.int16).numpy().copy()
    out["bf16_written"] = bf.view(torch.int16).numpy().copy()
    dist.set_mesh(None)
    return out


def body_ckpt_tp_o2(inputs):
    """A tensor-parallel GPT (mp 2 x dp 2) cast by ``amp.decorate`` O2
    after its layers set their layouts, saved from its default
    ``state_dict()`` (detached views of the new bf16 data), loaded into a
    whole (mp 1) model decorated the same way: every tensor the whole
    model's, bit for bit; and the same after ``Module.to``."""
    import os

    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.bridge import (
        from_paddle_tpu_state,
        to_paddle_tpu_state,
    )
    from paddle_tpu_torch.distributed.checkpoint import (
        load_state_dict,
        save_state_dict,
    )
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny

    _cpu()
    cfg = gpt_tiny()
    whole = GPTForCausalLM(cfg, device="cpu", seed=3, mp_group=False)
    state = to_paddle_tpu_state(whole)
    _, hcg = _hcg(dp=2, mp=2)
    out = {"mp": hcg.get_model_parallel_world_size()}
    for cast in ("O2", "to"):
        tp = from_paddle_tpu_state(state, cfg, device="cpu")
        ref = GPTForCausalLM(cfg, device="cpu", seed=3, mp_group=False)
        out[f"{cast}_qkv"] = tuple(
            tp.gpt.blocks[0].attn.qkv_proj.weight.shape)
        for m in (tp, ref):
            if cast == "O2":
                amp.decorate(m, level="O2", dtype="bfloat16")
            else:
                m.to(torch.bfloat16)
        path = os.path.join(inputs["dir"], f"tp_{cast}")
        save_state_dict(tp.state_dict(), path)
        want = {k: v.clone() for k, v in ref.state_dict().items()}
        with torch.no_grad():
            for p in ref.parameters():
                p.zero_()
        target = ref.state_dict()
        load_state_dict(target, path)
        out[cast] = {k: bool(torch.equal(target[k], want[k]))
                     for k in want}
    return out


def body_pp_scaler(inputs):
    """A GradScaler through ``train_batch`` over pp 2 x dp 2: one dp
    rank's batch holds an inf at step 1, so one stage's gradients there
    are not finite; every rank skips that step and halves its scale, and
    the next step trains on every rank."""
    import torch

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.bridge import stage_state
    from paddle_tpu_torch.distributed.fleet import (
        PipelineLayer,
        PipelineParallel,
    )

    micro, batch, hid = inputs["micro"], inputs["batch"], inputs["hid"]
    s, hcg = _hcg(pp=2, dp=2, micro=micro, batch=batch)
    model = PipelineLayer(_linear_descs(inputs["n_layers"], hid),
                          num_stages=2, loss_fn=_loss_mse)
    model.set_state_dict(stage_state(inputs["stack_state"], model))
    wrapper = PipelineParallel(model, hcg, strategy=s)
    opt = optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    data = _mse_data(0, batch, hid)
    before = {k: getattr(t, "_value", t).detach().clone()
              for k, t in model.state_dict().items()}
    x, y = (local_rows(a, hcg, micro) for a in data(0))
    if hcg.get_data_parallel_rank() == 1:
        x = x.copy()
        x[0, 0] = np.inf
    loss = wrapper.train_batch((torch.as_tensor(x), torch.as_tensor(y)),
                               opt, scaler=scaler)
    unchanged = all(torch.equal(getattr(t, "_value", t), before[k])
                    for k, t in model.state_dict().items())
    scale_after_bad = scaler._scale
    x, y = (local_rows(a, hcg, micro) for a in data(1))
    wrapper.train_batch((torch.as_tensor(x), torch.as_tensor(y)), opt,
                        scaler=scaler)
    moved = any(not torch.equal(getattr(t, "_value", t), before[k])
                for k, t in model.state_dict().items())
    return {"unchanged": unchanged, "scale": scale_after_bad,
            "moved": moved, "loss_finite": bool(np.isfinite(float(loss)))}
