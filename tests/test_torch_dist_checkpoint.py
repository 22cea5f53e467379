"""The sharded checkpoint of the port (``distributed.checkpoint``) on 4
gloo ranks against the JAX package's (``tests/test_dist_checkpoint.py``'s
seven bodies, with the port's layouts): a save under one mesh layout
restored under another, nested dicts and scalars, a missing key, an
async save, training resumed across a layout change (ZeRO-3 rows into a
DataParallel run's whole state) and a ZeRO-3 state round trip, bf16 and
the dtype helpers. Across the packages: a checkpoint JAX writes under
ZeRO-3 on its 8 devices loads into the port's ranks under ZeRO-1 and
training goes on as JAX's does; one the port's ranks write under ZeRO-3
loads into JAX's 8-device mesh with the port's values; bf16 both ways,
bit for bit. Losses within rtol 1e-5 (the JAX test's bound)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

import dist_ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn
from paddle_tpu.distributed.checkpoint import (
    load_state_dict as jax_load,
    np_dtype as jax_np_dtype,
    save_state_dict as jax_save,
)
from paddle_tpu.jit.train import TrainStep as JTrainStep

from paddle_tpu_torch.bridge import gather_parts
from paddle_tpu_torch.distributed.checkpoint import (
    np_dtype,
    readback_view,
    storable_view,
)


def _jax_make_step(mesh):
    with paddle.utils.unique_name.guard():
        paddle.seed(7)
        m = nn.Sequential(nn.Linear(16, 64), nn.ReLU(), nn.Linear(64, 4))
        o = paddle.optimizer.Adam(learning_rate=1e-2,
                                  parameters=m.parameters())
    o = jdist.shard_optimizer(o, jdist.ShardingStage3("dp", mesh))
    step = JTrainStep(m, lambda out, y: JF.cross_entropy(out, y), o)
    return m, o, step


def _state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("dist_ckpt"))
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((8, 16)).astype("float32") for _ in range(6)]
    ys = [rng.integers(0, 4, (8,)) for _ in range(6)]
    mesh = jdist.auto_mesh(8, dim_names=["dp"])
    prev = jdist.get_mesh()
    jdist.set_mesh(mesh)
    try:
        m, o, step = _jax_make_step(mesh)
        init = _state(m)
        losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
                  for x, y in zip(xs[:2], ys[:2])]
        jax_save({"model": m.state_dict(), "opt": o.state_dict()},
                 os.path.join(base, "jax_z3"))
        losses += [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
                   for x, y in zip(xs[2:4], ys[2:4])]
    finally:
        jdist.set_mesh(prev)
    bf = (np.arange(12).reshape(3, 4) / 3).astype(jax_np_dtype("bfloat16"))
    jax_save({"w": paddle.to_tensor(jnp.asarray(bf))},
             os.path.join(base, "jax_bf16"))
    r = np.random.default_rng(0)
    arrays = {"w1": r.standard_normal((16, 8)).astype("float32"),
              "w2": r.standard_normal((8, 24)).astype("float32"),
              "b": r.standard_normal((24,)).astype("float32")}
    inputs = {"dir": base, "arrays": arrays, "xs": xs, "ys": ys,
              "ckpt_init": init, "jax_z3": os.path.join(base, "jax_z3"),
              "jax_bf16": os.path.join(base, "jax_bf16")}
    bodies = ["body_ckpt_reshard", "body_ckpt_small", "body_ckpt_training",
              "body_ckpt_tp_o2"]
    ranks = dist_ranks.run_ranks([f"dist_pipeline_bodies:{b}"
                                  for b in bodies], 4, inputs,
                                 deadline_s=240)
    got = {b: [r[f"dist_pipeline_bodies:{b}"] for r in ranks]
           for b in bodies}
    return {"base": base, "jax_losses": losses, "bf": bf}, got


def test_save_then_reshard_load_roundtrip(runs):
    _, got = runs
    for r in got["body_ckpt_reshard"]:
        assert all(r["equal"].values()), r["equal"]
    # every rank wrote its own regions: w1 is split over all four
    assert got["body_ckpt_reshard"][0]["files"] == [
        f"data_r{i}.npz" for i in range(4)]


@pytest.mark.parametrize("cast", ["O2", "to"])
def test_tensor_parallel_checkpoint_after_a_cast(runs, cast):
    """A GPT at mp 2 whose parameters' data were replaced after its layers
    set their layouts (``amp.decorate`` O2, ``Module.to``), saved from its
    default ``state_dict()``: loaded at mp 1, every tensor equals the
    whole model's (both halves of each split weight were written)."""
    _, got = runs
    for r in got["body_ckpt_tp_o2"]:
        assert r["mp"] == 2
        assert r[f"{cast}_qkv"] == (64, 96)
        assert r[cast] and all(r[cast].values()), r[cast]


def test_nested_dict_and_scalars(runs):
    _, got = runs
    for r in got["body_ckpt_small"]:
        same, opt = r["nested"]
        assert same and opt == {"lr": 0.125, "step": 7, "name": "adam"}
        # dedup: the replicated tensor is written by one rank
        assert r["nested_files"] == ["data_r0.npz"]


def test_missing_key_raises(runs):
    _, got = runs
    for r in got["body_ckpt_small"]:
        assert r["missing"] is not None and "nope" in r["missing"]


def test_async_save(runs):
    _, got = runs
    assert all(r["async"] == 3.0 for r in got["body_ckpt_small"])


def test_training_resume_across_layout_change(runs):
    """ZeRO-3 rows saved, restored into a DataParallel run's whole state
    after a desyncing step: the continued losses are the uninterrupted
    run's."""
    _, got = runs
    for r in got["body_ckpt_training"]:
        first, cont, ref = r["resume"]
        np.testing.assert_allclose(first, ref[:3], rtol=1e-5)
        np.testing.assert_allclose(cont, ref[3:], rtol=1e-5)


def test_zero3_state_save_load(runs):
    _, got = runs
    for r in got["body_ckpt_training"]:
        l1, l2, ref = r["zero3"]
        np.testing.assert_allclose(l1, ref[:2], rtol=1e-5)
        np.testing.assert_allclose(l2, ref[2:], rtol=1e-5)


def test_jax_zero3_checkpoint_loads_into_port_ranks(runs):
    """Written by JAX under ZeRO-3 over 8 devices; read by 4 ranks under
    ZeRO-1 (each its rows of the moments, whole parameters): the next two
    steps are JAX's."""
    ctx, got = runs
    for r in got["body_ckpt_training"]:
        assert r["acc_rows"] == (4, 64)
        np.testing.assert_allclose(r["from_jax"], ctx["jax_losses"][2:],
                                   rtol=1e-5)


def test_port_zero3_checkpoint_loads_into_jax_mesh(runs):
    """Written by the port's 4 ranks under ZeRO-3 (rows); read by JAX into
    arrays on its 8-device mesh, ZeRO-3-sharded: the port's values."""
    ctx, got = runs
    ranks = got["body_ckpt_training"]
    assert all(r["param_rows"] == (4, 64) for r in ranks)
    params = gather_parts([r["port_z3"] for r in ranks])
    m1 = gather_parts([r["port_z3_m1"] for r in ranks])
    mesh = jdist.auto_mesh(8, dim_names=["dp"])
    prev = jdist.get_mesh()
    jdist.set_mesh(mesh)
    try:
        m, o, step = _jax_make_step(mesh)
        step(paddle.to_tensor(np.ones((8, 16), "float32")),
             paddle.to_tensor(np.zeros((8,), "int64")))
        target = {"model": m.state_dict(), "opt": {
            k: v for k, v in o.state_dict().items() if "moment" in k}}
        jax_load(target, os.path.join(ctx["base"], "port_z3"))
        for k, v in target["model"].items():
            np.testing.assert_array_equal(np.asarray(v._value), params[k])
        names = [k for k, _ in m.named_parameters()]
        for i, k in enumerate(names, 1):
            np.testing.assert_array_equal(
                np.asarray(target["opt"][f"tensor_{i}_moment1"]._value),
                m1[k])
    finally:
        jdist.set_mesh(prev)


def test_bf16_both_ways(runs):
    ctx, got = runs
    want = ctx["bf"].view(np.uint16).astype(np.int16)
    for r in got["body_ckpt_training"]:
        np.testing.assert_array_equal(r["bf16_from_jax"], want)
    target = {"w": paddle.to_tensor(jnp.zeros((3, 4), jnp.bfloat16))}
    jax_load(target, os.path.join(ctx["base"], "port_bf16"))
    gotj = np.asarray(target["w"]._value)
    assert gotj.dtype == jax_np_dtype("bfloat16")
    np.testing.assert_array_equal(
        gotj.view(np.uint16).astype(np.int16),
        got["body_ckpt_training"][0]["bf16_written"])


def test_dtype_helpers_are_inverse():
    """The port's own helpers: bf16 stored as its uint16 view beside the
    name; every itemsize class round-trips its bytes."""
    import torch

    assert np_dtype("bfloat16") == np.uint16
    for dt in (torch.bfloat16, torch.float32, torch.int8, torch.int64):
        t = torch.arange(6).to(dt)
        stored = storable_view(t)
        assert stored.dtype.kind != "V"
        name = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.int8: "int8", torch.int64: "int64"}[dt]
        back = readback_view(stored, name)
        assert back.dtype == dt and torch.equal(back, t)
