"""Rank bodies of the auto-parallel, reshard and ZeRO-norm tests
(``tests/test_torch_parallelize_api.py``, ``test_torch_reshard.py``,
``test_torch_zero_sharding.py``), run by ``dist_ranks.run_ranks``. Imports
torch, numpy and the port only; the inputs (weights, batches) come as
numpy arrays."""
from __future__ import annotations

import numpy as np

HID = 16
N_BLOCKS = 4


def _me():
    from paddle_tpu_torch.distributed import env

    return env.get_rank(), env.get_world_size()


def _cpu():
    import paddle_tpu_torch

    paddle_tpu_torch.set_device("cpu")


# ------------------------------------------------------ the plain model
def _plain_model(state):
    """``tests/test_parallelize_api.py``'s ``_PlainModel``: four blocks of
    up (HID -> 2 HID), relu, down (2 HID -> HID), with ``state``'s
    weights."""
    from paddle_tpu_torch import nn

    class _PlainBlock(nn.Layer):
        def __init__(self):
            super().__init__()
            self.up = nn.Linear(HID, HID * 2)
            self.down = nn.Linear(HID * 2, HID)

        def forward(self, x):
            return self.down(nn.functional.relu(self.up(x)))

    class _PlainModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.blocks = nn.LayerList([_PlainBlock()
                                        for _ in range(N_BLOCKS)])

        def forward(self, x):
            for b in self.blocks:
                x = b(x)
            return x

    model = _PlainModel()
    model.set_state_dict(state)
    return model


def _loss_fn(out, label):
    return ((out - label) ** 2).mean()


def _mp_plan(dist):
    return {r"blocks\.\d+\.up": dist.ColWiseParallel(),
            r"blocks\.\d+\.down": dist.RowWiseParallel()}


def _tensor(a):
    import torch

    from paddle_tpu_torch.tensor import Tensor

    return Tensor(torch.as_tensor(a))


def _own_params(model, dm):
    """The part record of the parameters this rank's pipeline stage
    updates (all of them without a pipeline)."""
    from paddle_tpu_torch.bridge import part_record

    rec = part_record(model)
    if dm is None or dm._engine is None:
        return rec
    mine = {id(q) for ch in dm._engine.chunks.values() for q in ch.params}
    names = {k for k, p in model.named_parameters() if id(p._value) in mine}
    return {k: v for k, v in rec.items() if k in names}


def _run_dm(inputs, mesh_shape, names, config, strategy=None, steps=5,
            optimizer="SGD", clip=None, evaluate=False):
    """``steps`` DistModel train steps of the plain model under
    ``parallelize(config)``; with ``evaluate``, then an eval loss and a
    predict output on the first batch."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import optimizer as optim

    _cpu()
    mesh = dist.ProcessMesh(np.arange(int(np.prod(mesh_shape))).reshape(
        mesh_shape), names)
    dist.auto_parallel.set_mesh(mesh)
    model = _plain_model(inputs["ap_state"])
    grad_clip = None if clip is None else nn.ClipGradByGlobalNorm(clip)
    if optimizer == "SGD":
        opt = optim.SGD(learning_rate=0.1, parameters=model.parameters(),
                        grad_clip=grad_clip)
    else:
        opt = optim.AdamW(learning_rate=1e-3,
                          parameters=model.parameters())
    model, opt = dist.parallelize(model, opt, config=config)
    dm = dist.to_static(model, loss=_loss_fn, optimizer=opt,
                        strategy=strategy)
    dm.train()
    losses = [float(dm(_tensor(x), _tensor(y)).numpy())
              for x, y in inputs["ap_data"][:steps]]
    out = {"losses": losses, "params": _own_params(model, dm),
           "bounds": getattr(model, "_pp_bounds", None)}
    if evaluate:
        x, y = (_tensor(a) for a in inputs["ap_data"][0])
        dm.eval()
        out["eval_loss"] = float(dm(x, y).numpy())
        dm.predict()
        out["predict"] = np.asarray(dm(x).numpy())
    dist.set_mesh(None)
    return out


def body_tp_annotations(inputs):
    import paddle_tpu_torch.distributed as dist

    _cpu()
    mesh = dist.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])
    dist.auto_parallel.set_mesh(mesh)
    model = _plain_model(inputs["ap_state"])
    from paddle_tpu_torch import optimizer as optim

    opt = optim.SGD(learning_rate=0.1, parameters=model.parameters())
    model, opt = dist.parallelize(
        model, opt, config={"mp_config": {"parallelize_plan":
                                          _mp_plan(dist)}})
    out = []
    for i in range(N_BLOCKS):
        b = model.blocks[i]
        row = {}
        for name, layer in (("up", b.up), ("down", b.down)):
            for pname in ("weight", "bias"):
                p = layer._parameters[pname]
                attr = getattr(p, "_dist_attr", None)
                row[f"{name}.{pname}"] = (
                    None if attr is None else repr(attr[1][1]),
                    tuple(p.shape))
        out.append(row)
    dist.set_mesh(None)
    return out


def body_tp_dp_level0(inputs):
    import paddle_tpu_torch.distributed as dist

    return _run_dm(inputs, (2, 4), ["dp", "mp"],
                   {"mp_config": {"parallelize_plan": _mp_plan(dist)}},
                   evaluate=True)


def body_tp_dp_clip(inputs):
    """A global-norm clip under TP x DP: the norm over every parameter's
    whole (a replicated one counted once)."""
    import paddle_tpu_torch.distributed as dist

    return _run_dm(inputs, (2, 4), ["dp", "mp"],
                   {"mp_config": {"parallelize_plan": _mp_plan(dist)}},
                   clip=inputs["ap_clip"])


def body_embedding_plans(inputs):
    """An Embedding under ``RowWiseParallel`` (vocabulary rows over "mp")
    and under ``ColWiseParallel(gather_output=True)`` (features): this
    rank's forward and its part of the weight's gradient of
    ``sum(out * C)``."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.bridge import part_record

    _cpu()
    mesh = dist.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])
    out = {}
    for name, plan in (("row", dist.RowWiseParallel()),
                       ("col", dist.ColWiseParallel(gather_output=True))):
        emb = nn.Sequential(nn.Embedding(*inputs["emb_w"].shape))
        emb.set_state_dict({"0.weight": inputs["emb_w"]})
        dist.parallelize(emb, None, mesh=mesh, config={
            "mp_config": {"parallelize_plan": {"0": plan}}})
        y = emb(_tensor(inputs["emb_ids"]))
        (y._value * torch.as_tensor(inputs["emb_c"])).sum().backward()
        w = emb[0]._parameters["weight"]
        out[name] = {"out": np.asarray(y.numpy()),
                     "grad": part_record(emb, {"0.weight": w.grad}),
                     "shape": tuple(w.shape)}
    return out


def body_tp_dp_level2(inputs):
    import paddle_tpu_torch.distributed as dist

    return _run_dm(inputs, (2, 4), ["dp", "mp"],
                   {"mp_config": {"parallelize_plan": _mp_plan(dist)},
                    "dp_config": {"sharding_level": 2}})


def body_pp_tp_zero_1f1b(inputs):
    import paddle_tpu_torch.distributed as dist

    return _run_dm(
        inputs, (2, 2, 2), ["pp", "dp", "mp"],
        {"mp_config": {"parallelize_plan": _mp_plan(dist)},
         "pp_config": {"split_spec": "blocks"},
         "dp_config": {"sharding_level": 2}},
        strategy=dist.Strategy({"pipeline": {
            "enable": True, "accumulate_steps": inputs["ap_micro"]}}),
        steps=6, evaluate=True)


def body_pp_tp_zero_zbh1(inputs):
    """``__graft_entry__.py``'s ``_dryrun_parallelize``: AdamW, ZB-H1,
    two micro-batches, one step (JAX's pipelined AdamW fails at its
    second: ROADMAP C, reference side)."""
    import paddle_tpu_torch.distributed as dist

    return _run_dm(
        inputs, (2, 2, 2), ["pp", "dp", "mp"],
        {"mp_config": {"parallelize_plan": _mp_plan(dist)},
         "pp_config": {"split_spec": "blocks"},
         "dp_config": {"sharding_level": 2}},
        strategy=dist.Strategy({"pipeline": {
            "enable": True, "schedule_mode": "ZB-H1",
            "accumulate_steps": 2}}),
        steps=1, optimizer="AdamW")


def body_pp_tp_zero_zbh1_sgd(inputs):
    """The headline's six SGD steps under ZB-H1."""
    import paddle_tpu_torch.distributed as dist

    return _run_dm(
        inputs, (2, 2, 2), ["pp", "dp", "mp"],
        {"mp_config": {"parallelize_plan": _mp_plan(dist)},
         "pp_config": {"split_spec": "blocks"},
         "dp_config": {"sharding_level": 2}},
        strategy=dist.Strategy({"pipeline": {
            "enable": True, "schedule_mode": "ZB-H1",
            "accumulate_steps": inputs["ap_micro"]}}),
        steps=6)


def body_pp_tp_zero_vpp(inputs):
    """The headline's six SGD steps with the chain re-cut into 2 x 2
    virtual chunks (``vpp_degree`` 2), round-robin over the stages."""
    import paddle_tpu_torch.distributed as dist

    return _run_dm(
        inputs, (2, 2, 2), ["pp", "dp", "mp"],
        {"mp_config": {"parallelize_plan": _mp_plan(dist)},
         "pp_config": {"split_spec": "blocks"},
         "dp_config": {"sharding_level": 2}},
        strategy=dist.Strategy({"pipeline": {
            "enable": True, "vpp_degree": 2,
            "accumulate_steps": inputs["ap_micro"]}}),
        steps=6)


def body_split_spec_dict(inputs):
    import paddle_tpu_torch.distributed as dist

    _cpu()
    mesh = dist.ProcessMesh(np.arange(8).reshape(2, 4), ["pp", "dp"])
    dist.auto_parallel.set_mesh(mesh)
    model = _plain_model(inputs["ap_state"])
    model, _ = dist.parallelize(model, None, config={
        "pp_config": {"split_spec": {"blocks.1": dist.SplitPoint.END}}})
    dist.set_mesh(None)
    return {"bounds": model._pp_bounds,
            "chain": [n for n, _ in model._pp_chain]}


def body_sequence_parallel(inputs):
    import paddle_tpu_torch.distributed as dist

    plan = _mp_plan(dist)
    plan["blocks.0"] = dist.SequenceParallelBegin()
    plan[f"blocks.{N_BLOCKS - 1}"] = dist.SequenceParallelEnd()
    return _run_dm(inputs, (2, 4), ["dp", "mp"],
                   {"mp_config": {"parallelize_plan": plan}}, steps=3)


def body_param_regex(inputs):
    import paddle_tpu_torch.distributed as dist

    _cpu()
    mesh = dist.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])
    dist.auto_parallel.set_mesh(mesh)
    model = _plain_model(inputs["ap_state"])
    model, _ = dist.parallelize(model, None, config={
        "mp_config": {"parallelize_plan": {
            r"blocks\.\d+\.up\.weight": dist.ColWiseParallel()}}})
    w = model.blocks[0].up._parameters["weight"]
    b = model.blocks[0].up._parameters["bias"]
    # the layer computes its part of the output (the bias cut with it)
    x = _tensor(np.asarray(inputs["ap_data"][0][0]))
    y = model.blocks[0].up(x)
    dist.set_mesh(None)
    return {"weight": (repr(w._dist_attr[1][1]), tuple(w.shape)),
            "bias_attr": getattr(b, "_dist_attr", None) is None,
            "out_shape": tuple(y.shape)}


def body_eval_predict(inputs):
    """No mesh: DistModel over one AdamW TrainStep on every rank."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import optimizer as optim

    _cpu()
    dist.set_mesh(None)
    model = _plain_model(inputs["ap_state"])
    opt = optim.AdamW(learning_rate=0.01, parameters=model.parameters())
    dm = dist.to_static(model, loss=_loss_fn, optimizer=opt)
    x, y = (_tensor(a) for a in inputs["ap_data"][0])
    dm.train()
    train_loss = float(dm(x, y).numpy())
    dm.eval()
    eval_loss = float(dm(x, y).numpy())
    dm.predict()
    out = dm(x)
    sd = dm.state_dict()
    return {"train_loss": train_loss, "eval_loss": eval_loss,
            "out_shape": list(out.shape),
            "out": np.asarray(out.numpy()),
            "all_keys": sorted(sd), "opt_keys": sorted(dm.state_dict("opt")),
            "model_keys": sorted(dm.state_dict("model")),
            "programs": (dm.dist_main_program(),
                         dm.dist_startup_program())}


def body_amp(inputs):
    """DistModel under ``Strategy.amp`` (O2 bf16) against a bare TrainStep
    under the same ``auto_cast`` over the same weights: bit-equal."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.jit import TrainStep

    _cpu()
    dist.set_mesh(None)
    cfg = {"enable": True, "dtype": "bfloat16", "level": "o2"}
    losses = {}
    for form in ("dist_model", "bare"):
        model = _plain_model(inputs["ap_state"])
        opt = optim.SGD(learning_rate=0.1, parameters=model.parameters())
        data = [(_tensor(x), _tensor(y)) for x, y in inputs["ap_data"][:3]]
        if form == "dist_model":
            dm = dist.to_static(model, loss=_loss_fn, optimizer=opt,
                                strategy=dist.Strategy({"amp": cfg}))
            losses[form] = [float(dm(x, y).numpy()) for x, y in data]
        else:
            step = TrainStep(model, _loss_fn, opt, split_label=True)
            with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
                losses[form] = [float(step(x, y)) for x, y in data]
    return losses


def body_to_distributed(inputs):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import optimizer as optim

    _cpu()
    out = {}
    for seq in (False, True):
        model = _plain_model(inputs["ap_state"])
        opt = optim.SGD(learning_rate=0.1, parameters=model.parameters())
        cfg = dist.ToDistributedConfig()
        cfg.sequence_parallel = seq
        loader = [tuple(_tensor(a) for a in inputs["ap_data"][0])]
        model, opt, loader = dist.to_distributed(model, opt, loader, 8,
                                                 config=cfg)
        mesh = dist.get_mesh()
        batch = next(iter(loader))
        out[seq] = {"shape": mesh.shape, "names": mesh.dim_names,
                    "stage": type(opt._shard_fn).__name__,
                    "rows": int(np.asarray(batch[0]).shape[0])}
        dist.set_mesh(None)
    return out


# --------------------------------------------------------------- reshard
def _reshard_meshes():
    import paddle_tpu_torch.distributed as dist

    return {"2d": dist.ProcessMesh([[0, 1], [2, 3]], ["x", "y"]),
            "1d": dist.ProcessMesh([0, 1, 2, 3], ["x"]),
            "sub": dist.ProcessMesh([1, 3], ["x"])}


def _placements(spec):
    import paddle_tpu_torch.distributed as dist

    out = []
    for s in spec:
        if s == "R":
            out.append(dist.Replicate())
        elif s == "P":
            out.append(dist.Partial())
        else:
            out.append(dist.Shard(int(s[1:])))
    return out


def body_reshard(inputs):
    """Each case: ``shard_tensor(X, src)`` then ``reshard`` to the target;
    this rank's part (None outside the target mesh). The gradient cases
    return this rank's gradient of its part of the source."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.tensor import Tensor

    _cpu()
    meshes = _reshard_meshes()
    X = inputs["rs_x"]
    out = {}
    for name, (sm, sp, tm, tp) in inputs["rs_cases"].items():
        src = dist.shard_tensor(torch.as_tensor(X), meshes[sm],
                                _placements(sp))
        got = dist.reshard(src, meshes[tm], _placements(tp))
        out[name] = (np.asarray(got._value) if meshes[tm].contains()
                     else None, got.placements == _placements(tp),
                     list(got.global_shape))
    C = inputs["rs_c"]
    for name, (sm, sp, tm, tp) in inputs["rs_grad_cases"].items():
        leaf = Tensor(torch.as_tensor(X).clone(), stop_gradient=False)
        src = dist.shard_tensor(leaf, meshes[sm], _placements(sp),
                                stop_gradient=False)
        got = dist.reshard(src, meshes[tm], _placements(tp))
        tmesh = meshes[tm]
        if tmesh.contains():
            c = dist.shard_tensor(torch.as_tensor(C), tmesh,
                                  _placements(tp))._value
        else:
            c = torch.zeros(0)
        (got._value * c).sum().backward()
        out[name] = np.asarray(leaf._value.grad)
    return out


# ------------------------------------------------------- ZeRO and norms
def _zero_norm_step(inputs, stage, kind):
    """5 steps of ``tests/test_torch_zero_sharding.py``'s model through
    TrainStep under ``ShardingStage{stage}``: Lamb, or AdamW with a
    per-tensor ``ClipGradByNorm``."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.bridge import part_record
    from paddle_tpu_torch.jit import TrainStep

    from dist_pipeline_bodies import _zero_model

    _cpu()
    rank, world = _me()
    mesh = dist.auto_mesh(world, dim_names=["dp"])
    dist.set_mesh(mesh)
    model = _zero_model(inputs["zero_state"])
    if kind == "lamb":
        opt = optimizer.Lamb(learning_rate=1e-2, lamb_weight_decay=0.01,
                             parameters=model.parameters())
    else:
        opt = optimizer.AdamW(learning_rate=1e-2,
                              parameters=model.parameters(),
                              grad_clip=nn.ClipGradByNorm(0.05))
    stage_cls = {1: dist.ShardingStage1, 2: dist.ShardingStage2,
                 3: dist.ShardingStage3}[stage]
    sopt = dist.shard_optimizer(opt, stage_cls("dp", mesh))
    x = torch.as_tensor(np.split(inputs["zero_x"], world)[rank])
    y = torch.as_tensor(np.split(inputs["zero_y"], world)[rank])
    loss_fn = nn.MSELoss()
    step = TrainStep(model, lambda o, t: loss_fn(o, t), sopt)
    losses = [float(step(x, y)) for _ in range(inputs["zero_steps"])]
    out = {"losses": losses, "params": part_record(model),
           "clip": type(opt._grad_clip).__name__ if opt._grad_clip
           else None}
    from paddle_tpu_torch.distributed import sharding

    sharding.uninstall(model)
    dist.set_mesh(None)
    return out


def body_zero_lamb1(inputs):
    return _zero_norm_step(inputs, 1, "lamb")


def body_zero_lamb2(inputs):
    return _zero_norm_step(inputs, 2, "lamb")


def body_zero_lamb3(inputs):
    return _zero_norm_step(inputs, 3, "lamb")


def body_zero_clip1(inputs):
    return _zero_norm_step(inputs, 1, "clip")


def body_zero_clip2(inputs):
    return _zero_norm_step(inputs, 2, "clip")


def body_zero_clip3(inputs):
    return _zero_norm_step(inputs, 3, "clip")


# ------------------------------------------------------------ auto-tuner
def body_tuner_trials(inputs):
    """``tests/test_auto_tuner.py``'s live-trial body on the port: the
    tuner's first three (dp, mp) candidates for 8 ranks, each trial a mesh
    of that shape, the plain model parallelized by its plan and three
    DistModel steps; the metric is the steps a second, the slowest rank's
    (every rank then ranks the trials alike)."""
    import time

    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.distributed.auto_tuner import AutoTuner, ModelSpec

    _cpu()
    spec = ModelSpec(num_params=1e6, num_layers=2, hidden=64, seq_len=32,
                     global_batch=16)
    tuner = AutoTuner({"world_size": 8, "model_spec": spec, "task_limit": 3,
                       "use_sharding": False, "max_pp": 1})
    rs = np.random.RandomState(0)
    blocks = {}
    for i in range(N_BLOCKS):
        blocks[f"blocks.{i}.up.weight"] = rs.randn(HID, 2 * HID) * 0.1
        blocks[f"blocks.{i}.up.bias"] = np.zeros(2 * HID)
        blocks[f"blocks.{i}.down.weight"] = rs.randn(2 * HID, HID) * 0.1
        blocks[f"blocks.{i}.down.bias"] = np.zeros(HID)
    state = {k: v.astype(np.float32) for k, v in blocks.items()}
    x = rs.randn(16, HID).astype(np.float32)
    y = rs.randn(16, HID).astype(np.float32)
    tried = []

    def trial(cfg):
        dp, mp = cfg["dp_degree"], cfg["mp_degree"]
        tried.append((dp, mp))
        mesh = dist.ProcessMesh(np.arange(8).reshape(dp, mp), ["dp", "mp"])
        dist.auto_parallel.set_mesh(mesh)
        try:
            model = _plain_model(state)
            opt = optim.SGD(learning_rate=0.1, parameters=model.parameters())
            config = ({"mp_config": {"parallelize_plan": _mp_plan(dist)}}
                      if mp > 1 else {})
            model, opt = dist.parallelize(model, opt, config=config)
            dm = dist.to_static(model, loss=_loss_fn, optimizer=opt)
            dm.train()
            float(dm(_tensor(x), _tensor(y)).numpy())
            t0 = time.perf_counter()
            for _ in range(3):
                float(dm(_tensor(x), _tensor(y)).numpy())
            rate = torch.tensor([3 / (time.perf_counter() - t0)])
            dist.all_reduce(rate, op="min")
            return float(rate)
        finally:
            dist.set_mesh(None)

    best = tuner.tune(trial)
    return {"best": best, "tried": len(tried),
            "best_cfg": None if best is None else best["cfg"]}
