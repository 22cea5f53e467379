"""The port's ``auto_parallel`` (``parallelize`` and its plans,
``to_static`` / ``DistModel``, ``Strategy``, ``to_distributed``) against
the JAX package's, body by body of ``tests/test_parallelize_api.py`` and
``__graft_entry__.py``'s ``_dryrun_parallelize``.

JAX runs each body once, in a module fixture, on its 8-device CPU mesh.
The port runs every body on 8 gloo ranks in one spawn
(``dist_ranks.run_ranks``, bodies in ``tests/dist_auto_bodies.py``), from
the same weights (JAX's ``paddle.seed(11)`` model, moved across as numpy
arrays) and the same batches. Held: the losses within rtol 1e-5 / atol
1e-6 of JAX's ``DistModel`` and of the single-device run, as the JAX test
holds them (``_dryrun_parallelize``'s ZB-H1 AdamW leg takes one step, as
the dryrun does: JAX's pipelined AdamW fails at a second, ROADMAP C); the
parameters after the steps, put together from every rank's
parts (the pipeline's from the ranks of their stage), within the same
tolerance of JAX's; ``_pp_bounds`` equal on both sides. The AMP body holds
``Strategy.amp`` to a bare ``TrainStep`` under the same ``auto_cast`` (bit
for bit) and to JAX's ``DistModel`` within bf16's rounding (rtol 2e-2).
"""
import subprocess
import sys
import warnings

import numpy as np
import pytest

import dist_ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn

from paddle_tpu_torch.bridge import gather_parts
from port_bodies import on_cpu  # noqa: F401

HID, BATCH, MICRO, N_BLOCKS = 16, 8, 4, 4

CLIP = 0.1
BODIES = ["body_tp_annotations", "body_tp_dp_level0", "body_tp_dp_level2",
          "body_tp_dp_clip", "body_embedding_plans",
          "body_pp_tp_zero_1f1b", "body_pp_tp_zero_zbh1",
          "body_pp_tp_zero_zbh1_sgd", "body_pp_tp_zero_vpp",
          "body_split_spec_dict", "body_sequence_parallel",
          "body_param_regex", "body_eval_predict", "body_amp",
          "body_to_distributed"]


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
        self.blocks = nn.LayerList([_PlainBlock() for _ in range(N_BLOCKS)])

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


def _loss_fn(out, label):
    return ((out - label) ** 2).mean()


def _data_np(step):
    rs = np.random.RandomState(100 + step)
    return (rs.randn(BATCH, HID).astype("float32"),
            rs.randn(BATCH, HID).astype("float32"))


def _data(step):
    return tuple(paddle.to_tensor(a) for a in _data_np(step))


def _state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def _model():
    paddle.seed(11)
    return _PlainModel()


def _mp_plan():
    return {r"blocks\.\d+\.up": jdist.ColWiseParallel(),
            r"blocks\.\d+\.down": jdist.RowWiseParallel()}


def _single_eval(steps, micro):
    """The single-device run's eval loss and forward on the first batch
    after its steps (JAX's pipelined DistModel cannot evaluate: its
    forward meets weights on two stages' devices, ROADMAP C)."""
    model = _run_single(steps, micro, keep=True)
    x, y = _data(0)
    out = model(x)
    return {"eval_loss": float(_loss_fn(out, y)),
            "predict": np.asarray(out._value)}


def _run_single(steps, micro=1, keep=False):
    jdist.set_mesh(None)
    model = _model()
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    losses = []
    for step in range(steps):
        x, y = _data(step)
        if micro > 1:
            total = 0.0
            for mx, my in zip(paddle.split(x, micro, axis=0),
                              paddle.split(y, micro, axis=0)):
                loss = _loss_fn(model(mx), my)
                (loss / micro).backward()
                total += float(loss)
            losses.append(total / micro)
        else:
            loss = _loss_fn(model(x), y)
            loss.backward()
            losses.append(float(loss))
        opt.step()
        opt.clear_grad()
    return model if keep else losses


def _run_dm(mesh_shape, names, config, strategy=None, steps=5,
            optimizer="SGD", clip=None, evaluate=False):
    jdist.set_mesh(None)
    mesh = jdist.ProcessMesh(np.arange(int(np.prod(mesh_shape))).reshape(
        mesh_shape), names)
    jdist.auto_parallel.set_mesh(mesh)
    try:
        model = _model()
        grad_clip = None if clip is None else nn.ClipGradByGlobalNorm(clip)
        if optimizer == "SGD":
            opt = paddle.optimizer.SGD(learning_rate=0.1,
                                       parameters=model.parameters(),
                                       grad_clip=grad_clip)
        else:
            opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=model.parameters())
        model, opt = jdist.parallelize(model, opt, config=config)
        dm = jdist.to_static(model, loss=_loss_fn, optimizer=opt,
                             strategy=strategy)
        dm.train()
        losses = [float(dm(*_data(s)).numpy()) for s in range(steps)]
        out = {"losses": losses, "params": _state(model),
               "bounds": getattr(model, "_pp_bounds", None)}
        if evaluate:
            x, y = _data(0)
            dm.eval()
            out["eval_loss"] = float(dm(x, y).numpy())
            dm.predict()
            out["predict"] = np.asarray(dm(x)._value)
        return out
    finally:
        jdist.set_mesh(None)


def _jax_embedding():
    """The unsharded Embedding's output and weight gradient (what JAX's
    plans, annotations over global arrays, compute) and the inputs."""
    rs = np.random.RandomState(3)
    paddle.seed(5)
    emb = nn.Embedding(32, 16)
    w = np.asarray(emb.weight._value)
    ids = rs.randint(0, 32, (4, 5)).astype("int64")
    c = rs.randn(4, 5, 16).astype("float32")
    y = emb(paddle.to_tensor(ids))
    (y * paddle.to_tensor(c)).sum().backward()
    return {"w": w, "ids": ids, "c": c, "out": np.asarray(y._value),
            "grad": np.asarray(emb.weight.grad._value)}


def _jax_annotations():
    jdist.set_mesh(None)
    mesh = jdist.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])
    jdist.auto_parallel.set_mesh(mesh)
    try:
        model = _model()
        model, _ = jdist.parallelize(
            model, None, config={"mp_config": {"parallelize_plan":
                                               _mp_plan()}})
        out = []
        for i in range(N_BLOCKS):
            row = {}
            for name in ("up", "down"):
                for pname in ("weight", "bias"):
                    p = getattr(getattr(model.blocks[i], name), pname)
                    attr = getattr(p, "_dist_attr", None)
                    row[f"{name}.{pname}"] = (
                        None if attr is None else attr[1][1].dim)
            out.append(row)
        return out
    finally:
        jdist.set_mesh(None)


def _jax_eval_predict():
    jdist.set_mesh(None)
    model = _model()
    opt = paddle.optimizer.AdamW(learning_rate=0.01,
                                 parameters=model.parameters())
    dm = jdist.to_static(model, loss=_loss_fn, optimizer=opt)
    x, y = _data(0)
    dm.train()
    train_loss = float(dm(x, y).numpy())
    dm.eval()
    eval_loss = float(dm(x, y).numpy())
    dm.predict()
    out = np.asarray(dm(x)._value)
    return {"train_loss": train_loss, "eval_loss": eval_loss, "out": out,
            "all_keys": sorted(dm.state_dict()),
            "opt_keys": sorted(dm.state_dict(mode="opt")),
            "model_keys": sorted(dm.state_dict(mode="model"))}


def _jax_amp():
    jdist.set_mesh(None)
    model = _model()
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    dm = jdist.to_static(model, loss=_loss_fn, optimizer=opt,
                         strategy=jdist.Strategy({"amp": {
                             "enable": True, "dtype": "bfloat16",
                             "level": "o2"}}))
    return [float(dm(*_data(s)).numpy()) for s in range(3)]


def _jax_to_distributed():
    out = {}
    for seq in (False, True):
        model = _model()
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=model.parameters())
        from paddle_tpu.distributed.auto_parallel.parallelize import (
            ToDistributedConfig, to_distributed,
        )

        cfg = ToDistributedConfig()
        cfg.sequence_parallel = seq
        _, opt, _ = to_distributed(model, opt, [_data(0)], 8, config=cfg)
        mesh = jdist.get_mesh()
        out[seq] = {"shape": list(mesh.shape), "names": mesh.dim_names,
                    "stage": type(opt._shard_fn).__name__}
        jdist.set_mesh(None)
    return out


@pytest.fixture(scope="module")
def runs():
    init = _state(_model())
    jx = {
        "annotations": _jax_annotations(),
        "single5": _run_single(5),
        "single6_micro": _run_single(6, micro=MICRO),
        "single3": _run_single(3),
        "level0": _run_dm((2, 4), ["dp", "mp"],
                          {"mp_config": {"parallelize_plan": _mp_plan()}},
                          evaluate=True),
        "clip": _run_dm((2, 4), ["dp", "mp"],
                        {"mp_config": {"parallelize_plan": _mp_plan()}},
                        clip=CLIP),
        "embedding": _jax_embedding(),
        "level2": _run_dm((2, 4), ["dp", "mp"],
                          {"mp_config": {"parallelize_plan": _mp_plan()},
                           "dp_config": {"sharding_level": 2}}),
        "pp_1f1b": _run_dm(
            (2, 2, 2), ["pp", "dp", "mp"],
            {"mp_config": {"parallelize_plan": _mp_plan()},
             "pp_config": {"split_spec": "blocks"},
             "dp_config": {"sharding_level": 2}},
            strategy=jdist.Strategy({"pipeline": {
                "enable": True, "accumulate_steps": MICRO}}), steps=6),
        "pp_1f1b_eval": _single_eval(6, MICRO),
        "pp_vpp": _run_dm(
            (2, 2, 2), ["pp", "dp", "mp"],
            {"mp_config": {"parallelize_plan": _mp_plan()},
             "pp_config": {"split_spec": "blocks"},
             "dp_config": {"sharding_level": 2}},
            strategy=jdist.Strategy({"pipeline": {
                "enable": True, "vpp_degree": 2,
                "accumulate_steps": MICRO}}), steps=6),
        "pp_zbh1": _run_dm(
            (2, 2, 2), ["pp", "dp", "mp"],
            {"mp_config": {"parallelize_plan": _mp_plan()},
             "pp_config": {"split_spec": "blocks"},
             "dp_config": {"sharding_level": 2}},
            strategy=jdist.Strategy({"pipeline": {
                "enable": True, "schedule_mode": "ZB-H1",
                "accumulate_steps": 2}}), steps=1, optimizer="AdamW"),
        "pp_zbh1_sgd": _run_dm(
            (2, 2, 2), ["pp", "dp", "mp"],
            {"mp_config": {"parallelize_plan": _mp_plan()},
             "pp_config": {"split_spec": "blocks"},
             "dp_config": {"sharding_level": 2}},
            strategy=jdist.Strategy({"pipeline": {
                "enable": True, "schedule_mode": "ZB-H1",
                "accumulate_steps": MICRO}}), steps=6),
        "eval_predict": _jax_eval_predict(),
        "amp": _jax_amp(),
        "to_distributed": _jax_to_distributed(),
    }
    plan = _mp_plan()
    plan["blocks.0"] = jdist.SequenceParallelBegin()
    plan[f"blocks.{N_BLOCKS - 1}"] = jdist.SequenceParallelEnd()
    jx["sp"] = _run_dm((2, 4), ["dp", "mp"],
                       {"mp_config": {"parallelize_plan": plan}}, steps=3)
    emb = jx["embedding"]
    inputs = {"ap_state": init, "ap_data": [_data_np(s) for s in range(6)],
              "ap_micro": MICRO, "ap_clip": CLIP, "emb_w": emb["w"],
              "emb_ids": emb["ids"], "emb_c": emb["c"]}
    ranks = dist_ranks.run_ranks([f"dist_auto_bodies:{b}" for b in BODIES],
                                 8, inputs)
    got = {b: [r[f"dist_auto_bodies:{b}"] for r in ranks] for b in BODIES}
    return init, jx, got


def _hold(got_ranks, want, ref=None):
    """Every rank's losses against JAX's (and the single-device run's);
    the parameters put together from the ranks against JAX's."""
    for r in got_ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5,
                                   atol=1e-6)
        if ref is not None:
            np.testing.assert_allclose(r["losses"], ref, rtol=1e-5,
                                       atol=1e-6)
    whole = gather_parts([r["params"] for r in got_ranks])
    assert sorted(whole) == sorted(want["params"])
    for k, v in whole.items():
        np.testing.assert_allclose(v, want["params"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_parallelize_tp_sharding_annotations(runs):
    _, jx, got = runs
    for r in got["body_tp_annotations"][:4]:
        for i, row in enumerate(r):
            for key, (placement, shape) in row.items():
                dim = jx["annotations"][i][key]
                assert placement == (None if dim is None
                                     else f"Shard(dim={dim})"), (i, key)
        assert r[0]["up.weight"][1] == (HID, HID * 2 // 4)
        assert r[0]["down.weight"][1] == (HID * 2 // 4, HID)


@pytest.mark.parametrize("sharding_level", [0, 2])
def test_to_static_tp_dp_parity(runs, sharding_level):
    _, jx, got = runs
    _hold(got[f"body_tp_dp_level{sharding_level}"],
          jx[f"level{sharding_level}"], jx["single5"])


def test_to_static_pp_tp_zero_parity(runs):
    """The headline: TP + PP + ZeRO-2 on [pp 2, dp 2, mp 2] under 1F1B."""
    _, jx, got = runs
    ranks = got["body_pp_tp_zero_1f1b"]
    assert jx["pp_1f1b"]["bounds"] == [0, N_BLOCKS // 2, N_BLOCKS]
    for r in ranks:
        assert r["bounds"] == jx["pp_1f1b"]["bounds"]
    _hold(ranks, jx["pp_1f1b"], jx["single6_micro"])


@pytest.mark.parametrize("body,key", [("body_tp_dp_level0", "level0"),
                                      ("body_pp_tp_zero_1f1b",
                                       "pp_1f1b_eval")])
def test_eval_and_predict_after_training(runs, body, key):
    """Eval and predict of the trained DistModel on the global batch:
    under TP x DP (each rank's dp rows, the loss averaged) against JAX's
    DistModel, and through the pipeline's forward-only window (the
    outputs broadcast from the last stage) against JAX's single-device
    model after the same steps, rtol 1e-5 / atol 1e-6."""
    _, jx, got = runs
    for r in got[body]:
        np.testing.assert_allclose(r["eval_loss"], jx[key]["eval_loss"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["predict"], jx[key]["predict"],
                                   rtol=1e-5, atol=1e-6)


def test_global_norm_clip_under_tp_dp(runs):
    """``ClipGradByGlobalNorm`` under TP x DP: the norm over the whole
    parameters (a cut one summed over "mp", a replicated one counted
    once), as JAX's over its global arrays."""
    _, jx, got = runs
    _hold(got["body_tp_dp_clip"], jx["clip"], None)


@pytest.mark.parametrize("plan", ["row", "col"])
def test_embedding_plans(runs, plan):
    """An Embedding under ``RowWiseParallel`` (vocabulary rows: ids
    outside this rank's look up zeros, the parts all-reduced) and
    ``ColWiseParallel(gather_output=True)``: the output and the weight's
    gradient, put together from the ranks, equal JAX's."""
    _, jx, got = runs
    want = jx["embedding"]
    ranks = [r[plan] for r in got["body_embedding_plans"]]
    for r in ranks:
        np.testing.assert_allclose(r["out"], want["out"], rtol=1e-6,
                                   atol=1e-7)
        assert r["shape"] == ((32 // 4, 16) if plan == "row" else (32, 4))
    grad = gather_parts([r["grad"] for r in ranks])["0.weight"]
    np.testing.assert_allclose(grad, want["grad"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("body,ref", [("zbh1", None),
                                      ("zbh1_sgd", "single6_micro"),
                                      ("vpp", "single6_micro")])
def test_to_static_pp_tp_zero_zero_bubble(runs, body, ref):
    """The same under ZB-H1: ``_dryrun_parallelize``'s AdamW step (JAX's
    pipelined AdamW fails at a second step: ROADMAP C, reference side),
    and the headline's six SGD steps; and under 1F1B over 2 x 2 virtual
    chunks (VPP)."""
    _, jx, got = runs
    ranks = got[f"body_pp_tp_zero_{body}"]
    for r in ranks:
        assert r["bounds"] == jx[f"pp_{body}"]["bounds"]
    _hold(ranks, jx[f"pp_{body}"], None if ref is None else jx[ref])


def test_to_static_pp_split_spec_dict(runs):
    _, _, got = runs
    jdist.set_mesh(None)
    mesh = jdist.ProcessMesh(np.arange(2).reshape(2), ["pp"])
    jdist.auto_parallel.set_mesh(mesh)
    try:
        model, _ = jdist.parallelize(_model(), None, config={
            "pp_config": {"split_spec": {"blocks.1": jdist.SplitPoint.END}}})
        want = model._pp_bounds
    finally:
        jdist.set_mesh(None)
    assert want == [0, 2, 4]
    for r in got["body_split_spec_dict"]:
        assert r["bounds"] == want
        assert r["chain"] == [f"blocks.{i}" for i in range(N_BLOCKS)]


def test_sequence_parallel_plan(runs):
    _, jx, got = runs
    _hold(got["body_sequence_parallel"], jx["sp"], jx["single3"])


def test_eval_and_predict_modes(runs):
    _, jx, got = runs
    want = jx["eval_predict"]
    for r in got["body_eval_predict"]:
        assert r["eval_loss"] < r["train_loss"]
        np.testing.assert_allclose(r["train_loss"], want["train_loss"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["eval_loss"], want["eval_loss"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["out"], want["out"], rtol=1e-5,
                                   atol=1e-6)
        assert r["out_shape"] == [BATCH, HID]
        assert r["model_keys"] == want["model_keys"]
        assert set(r["all_keys"]) == set(r["model_keys"]) | set(
            r["opt_keys"])
        assert any(k.endswith(".moment1") for k in r["opt_keys"])
        assert set(r["opt_keys"]) <= set(want["opt_keys"])
        assert r["programs"] == (None, None)


def test_strategy_config_tree():
    from paddle_tpu_torch import distributed as tdist

    cfg = {"sharding": {"enable": True, "stage": 2},
           "amp": {"enable": True, "dtype": "bfloat16"},
           "pipeline": {"enable": True, "schedule_mode": "1F1B",
                        "accumulate_steps": 4}}
    s, j = tdist.Strategy(cfg), jdist.Strategy(cfg)
    assert s.sharding.stage == 2 and s.sharding.enable
    assert s.amp.dtype == "bfloat16"
    assert s.pipeline.accumulate_steps == 4
    for group in ("sharding", "amp", "pipeline", "gradient_merge",
                  "fused_passes"):
        assert getattr(s, group).to_dict() == getattr(j, group).to_dict()
    assert tdist.Strategy().amp.to_dict() == jdist.Strategy().amp.to_dict()
    with pytest.raises(ValueError):
        tdist.Strategy({"bogus": {}})
    with pytest.raises(ValueError):
        tdist.Strategy({"sharding": {"nope": 1}})


def test_missing_exports_now_exist():
    """The exports JAX's test lists, ``to_distributed``, the launcher, the
    store and ``fleet.elastic``: importing them pulls in no JAX and no
    module of the JAX package."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.distributed as d\n"
        "for n in ['to_static', 'DistModel', 'Strategy', 'parallelize',\n"
        "          'ColWiseParallel', 'RowWiseParallel',\n"
        "          'SequenceParallelBegin', 'SequenceParallelEnd',\n"
        "          'SequenceParallelEnable', 'SequenceParallelDisable',\n"
        "          'PrepareLayerInput', 'PrepareLayerOutput', 'SplitPoint',\n"
        "          'LocalLayer', 'to_distributed', 'ToDistributedConfig',\n"
        "          'TCPStore', 'launch']:\n"
        "    assert hasattr(d, n), n\n"
        "assert hasattr(d.auto_parallel, 'set_mesh')\n"
        "assert hasattr(d.auto_parallel, 'get_mesh')\n"
        "from paddle_tpu_torch.distributed.fleet import elastic\n"
        "from paddle_tpu_torch.distributed.launch import main\n"
        "from paddle_tpu_torch.distributed.store import TCPStore\n"
        "assert elastic.ElasticManager and elastic.AutoCheckpointer\n"
        "bad = [m for m in sys.modules if m == 'jax' or\n"
        "       m.startswith('jax.') or m == 'paddle_tpu' or\n"
        "       m.startswith('paddle_tpu.')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_param_level_regex_plan_key(runs):
    """A regex layer path + ``.weight`` cuts only the weight; the layer
    still computes (its bias cut to the output's part in the forward)."""
    _, _, got = runs
    for r in got["body_param_regex"]:
        assert r["weight"] == ("Shard(dim=1)", (HID, HID * 2 // 4))
        assert r["bias_attr"]
        assert r["out_shape"] == (BATCH, HID * 2 // 4)


def test_amp_path(runs):
    _, jx, got = runs
    for r in got["body_amp"]:
        assert r["dist_model"] == r["bare"]
        np.testing.assert_allclose(r["dist_model"], jx["amp"], rtol=2e-2)


def test_to_distributed(runs):
    _, jx, got = runs
    for r in got["body_to_distributed"]:
        for seq in (False, True):
            assert r[seq]["shape"] == jx["to_distributed"][seq]["shape"]
            assert r[seq]["names"] == jx["to_distributed"][seq]["names"]
            assert r[seq]["stage"] == jx["to_distributed"][seq]["stage"]
        assert r[False]["rows"] == BATCH // 8
        assert r[True]["rows"] == BATCH // 4


def test_config_edges_warn_and_raise(on_cpu):
    """JAX's edges: unknown keys raise; no mesh ignores the config with a
    warning; an unmatched key warns; a dim that does not divide stays
    whole with a warning."""
    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch import nn as tnn

    model = tnn.Sequential(tnn.Linear(4, 5))
    tdist.set_mesh(None)
    with pytest.raises(ValueError, match="unknown parallelize"):
        tdist.parallelize(model, None, config={"bogus": {}})
    with pytest.warns(UserWarning, match="IGNORED"):
        tdist.parallelize(model, None, config={"mp_config": {}})
    mesh = tdist.ProcessMesh(np.arange(3).reshape(1, 3), ["dp", "mp"])
    with pytest.warns(UserWarning, match="matched no layer"):
        tdist.parallelize(model, None, mesh=mesh, config={
            "mp_config": {"parallelize_plan": {
                "nothing": tdist.ColWiseParallel()}}})
    with pytest.warns(UserWarning, match="cannot shard dim 1"):
        tdist.parallelize(model, None, mesh=mesh, config={
            "mp_config": {"parallelize_plan": {
                "0": tdist.ColWiseParallel()}}})
    assert list(model[0].weight.shape) == [4, 5]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tdist.get_mesh() is None
