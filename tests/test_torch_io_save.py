"""``paddle.save`` / ``paddle.load`` on both packages, and files crossing
between them.

The JAX package's test bodies (``tests/test_compat_io_debugging.py``'s
reference-checkpoint import, ``tests/test_checkpoint.py``'s io_utils
satellites) run on each package (``port_bodies.run``: the port's results
equal to the JAX package's, f32 at rtol 1e-5, everything else exactly).
Files written by one package's ``save`` are read by the other's ``load``
in both directions: values bit for bit, dtypes (bfloat16 included, which
the JAX package keeps as an ``ml_dtypes`` numpy array) and
``stop_gradient``.
"""
import os
import pickle
import tempfile

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as port
from port_bodies import dname, npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


class _FakeEagerTensor:
    """Reduces as a real paddle eager Tensor does (reference
    framework/io.py:413: ``(tuple, ((name, ndarray),))``)."""

    def __init__(self, name, data):
        self.name = name
        self.data = data

    def __reduce__(self):
        return (tuple, ((self.name, self.data),))


class _FakeDenseTensor:
    """reduce_DenseTensor: ``(eval, ('data', {'data': ndarray}))``."""

    def __init__(self, data):
        self.data = data

    def __reduce__(self):
        return (eval, ("data", {"data": self.data}))


def _mlp(paddle):
    nn = paddle.nn
    return nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 1))


def reference_pdparams(paddle):
    rs = np.random.RandomState(0)
    w0, b0 = rs.randn(4, 8).astype("float32"), rs.randn(8).astype("float32")
    w1, b1 = rs.randn(8, 1).astype("float32"), rs.randn(1).astype("float32")
    state = {"0.weight": _FakeEagerTensor("linear_0.w_0", w0),
             "0.bias": _FakeEagerTensor("linear_0.b_0", b0),
             "2.weight": _FakeEagerTensor("linear_1.w_0", w1),
             "2.bias": _FakeDenseTensor(b1)}
    path = os.path.join(tempfile.mkdtemp(), "model.pdparams")
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=4)
    loaded = paddle.load(path)
    assert set(loaded) == set(state)
    assert all(isinstance(v, paddle.Tensor) for v in loaded.values())
    model = _mlp(paddle)
    model.set_state_dict(loaded)
    out = model(paddle.to_tensor(rs.randn(2, 4).astype("float32")))
    return {"w0": npy(loaded["0.weight"]), "b1": npy(loaded["2.bias"]),
            "model_w0": npy(model[0].weight), "out": npy(out)}


def own_format_roundtrip(paddle):
    model = paddle.nn.Linear(3, 2)
    model.set_state_dict({"weight": np.arange(6, dtype="float32")
                          .reshape(3, 2), "bias": np.ones(2, "float32")})
    p = os.path.join(tempfile.mkdtemp(), "own.pdparams")
    paddle.save(model.state_dict(), p)
    loaded = paddle.load(p)
    return {"weight": npy(loaded["weight"]), "bias": npy(loaded["bias"]),
            "stop_gradient": loaded["weight"].stop_gradient,
            "dtype": dname(loaded["weight"])}


def all_ndarray_dict_roundtrips_and_reference_converts(paddle):
    ours = {"a": np.arange(4, dtype="float32"),
            "b": np.ones((2, 2), dtype="int64")}
    d = tempfile.mkdtemp()
    paddle.save(ours, os.path.join(d, "ours.pdparams"))
    loaded = paddle.load(os.path.join(d, "ours.pdparams"))
    assert all(isinstance(loaded[k], np.ndarray) for k in ours)
    with open(os.path.join(d, "ref.pdparams"), "wb") as f:
        pickle.dump(ours, f, protocol=4)
    ref = paddle.load(os.path.join(d, "ref.pdparams"))
    assert all(isinstance(ref[k], paddle.Tensor) for k in ours)
    return {"ours_a": loaded["a"], "ours_b": loaded["b"],
            "ref_a": npy(ref["a"]), "ref_b": npy(ref["b"]),
            "ref_b_dtype": dname(ref["b"])}


def params_opt_state_nested(paddle):
    model = _mlp(paddle)
    rng = np.random.default_rng(0)
    model.set_state_dict({k: rng.standard_normal(t.shape).astype("float32")
                          for k, t in model.state_dict().items()})
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
    x = paddle.to_tensor(rng.standard_normal((2, 4)).astype("float32"))
    model(x).sum().backward()
    opt.step()
    state = {"model": model.state_dict(), "opt": opt.state_dict(),
             "extra": {"history": [1.5, 2.5],
                       "arrays": np.arange(6).reshape(2, 3),
                       "tup": (np.float32(1.0), "tag", None)}}
    p = os.path.join(tempfile.mkdtemp(), "ck.pdparams")
    paddle.save(state, p)
    loaded = paddle.load(p)
    assert all(isinstance(v, paddle.Tensor)
               for v in loaded["model"].values())
    assert isinstance(loaded["extra"]["arrays"], np.ndarray)
    assert loaded["extra"]["tup"] == state["extra"]["tup"]
    assert loaded["extra"]["history"] == [1.5, 2.5]
    out = {f"model.{k}": npy(v) for k, v in loaded["model"].items()}
    out["step"] = loaded["opt"]["@step"]
    # the packages name unnamed parameters differently: the accumulators
    # are compared by kind
    out["opt_kinds"] = tuple(sorted(k.rsplit("_", 1)[-1]
                                    for k, v in loaded["opt"].items()
                                    if isinstance(v, paddle.Tensor)))
    out["arrays"] = loaded["extra"]["arrays"]
    return out


BODIES = [reference_pdparams, own_format_roundtrip,
          all_ndarray_dict_roundtrips_and_reference_converts,
          params_opt_state_nested]


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_save_load_body(on_cpu, body, pkg):
    run(body, pkg)


@PKG
def test_save_is_crash_safe_torn_write_keeps_old_file(on_cpu, tmp_path,
                                                      monkeypatch, pkg):
    """A death mid-pickle leaves the old file as it was and no temp file
    (each package's pickling call is the one made to die)."""
    from paddle_tpu.inference.faults import ThreadDeath

    paddle = {"jax": paddle_tpu, "torch": port}[pkg]
    io_utils = paddle.framework.io_utils
    path = str(tmp_path / "state.pdparams")
    io_utils.save({"w": paddle.to_tensor(np.arange(4, dtype="float32"))},
                  path)
    good = open(path, "rb").read()

    def torn(obj, f, *a, **k):
        f.write(b"\x80\x04partial-garbage")
        raise ThreadDeath()

    if pkg == "jax":
        monkeypatch.setattr(io_utils.pickle, "dump", torn)
    else:
        monkeypatch.setattr(io_utils, "dump", torn)
    with pytest.raises(ThreadDeath):
        io_utils.save({"w": paddle.to_tensor(np.zeros(4, "float32"))}, path)
    monkeypatch.undo()
    assert open(path, "rb").read() == good
    assert [n for n in os.listdir(tmp_path) if ".tmp" in n] == []
    np.testing.assert_array_equal(npy(paddle.load(path)["w"]),
                                  np.arange(4, dtype="float32"))


def _mixed(rng):
    """Values of every kind the state dicts hold, as numpy."""
    return {"f32": rng.standard_normal((3, 4)).astype("float32"),
            "bf16": rng.standard_normal((5, 2)).astype("float32"),
            "i64": rng.integers(0, 9, (4,)).astype("int64"),
            "f64": rng.standard_normal(3)}


def test_port_files_load_in_the_jax_package(on_cpu, tmp_path):
    import ml_dtypes

    vals = _mixed(np.random.default_rng(1))
    bf16 = torch.from_numpy(vals["bf16"]).to(torch.bfloat16)
    obj = {"w": port.to_tensor(vals["f32"], stop_gradient=False),
           "h": port.Tensor(bf16),
           "raw_bf16": bf16,                     # a bare torch tensor
           "i": port.to_tensor(vals["i64"]),
           "nested": [port.to_tensor(vals["f64"]), (3, "x")],
           "@step": 7, "np": vals["i64"]}
    path = str(tmp_path / "port.pdparams")
    port.save(obj, path)
    got = paddle_tpu.load(path)
    assert isinstance(got["w"], paddle_tpu.Tensor)
    assert got["w"].stop_gradient is False and got["h"].stop_gradient is True
    np.testing.assert_array_equal(np.asarray(got["w"]._value), vals["f32"])
    for k in ("h", "raw_bf16"):
        arr = np.asarray(got[k]._value)
        assert arr.dtype == ml_dtypes.bfloat16, k
        np.testing.assert_array_equal(
            arr.view(np.uint16), bf16.view(torch.int16).numpy().view(
                np.uint16))
    assert np.asarray(got["i"]._value).dtype == np.int64
    np.testing.assert_array_equal(np.asarray(got["nested"][0]._value),
                                  vals["f64"])
    assert got["nested"][1] == (3, "x") and got["@step"] == 7
    np.testing.assert_array_equal(got["np"], vals["i64"])


def test_jax_files_load_in_the_port(on_cpu, tmp_path):
    import jax.numpy as jnp
    import ml_dtypes

    vals = _mixed(np.random.default_rng(2))
    w = paddle_tpu.to_tensor(vals["f32"])
    w.stop_gradient = False
    obj = {"w": w,
           "h": paddle_tpu.Tensor(jnp.asarray(vals["bf16"], jnp.bfloat16)),
           "i": paddle_tpu.to_tensor(vals["i64"]),
           "nested": [paddle_tpu.to_tensor(vals["f64"]), (3, "x")],
           "@step": 7, "np": vals["i64"],
           "raw_bf16": vals["bf16"].astype(ml_dtypes.bfloat16)}
    path = str(tmp_path / "jax.pdparams")
    paddle_tpu.save(obj, path)
    got = port.load(path)
    assert isinstance(got["w"], port.Tensor)
    assert got["w"].stop_gradient is False
    np.testing.assert_array_equal(got["w"].numpy(), vals["f32"])
    assert got["h"].dtype == torch.bfloat16 and got["h"].stop_gradient
    np.testing.assert_array_equal(
        got["h"]._value.view(torch.int16).numpy().view(np.uint16),
        vals["bf16"].astype(ml_dtypes.bfloat16).view(np.uint16))
    assert got["i"].dtype == torch.int64
    np.testing.assert_array_equal(got["nested"][0].numpy(), vals["f64"])
    assert got["nested"][1] == (3, "x") and got["@step"] == 7
    np.testing.assert_array_equal(got["np"], vals["i64"])
    # a bare bfloat16 array: float32 holds it exactly
    assert got["raw_bf16"].dtype == np.float32
    np.testing.assert_array_equal(
        got["raw_bf16"], vals["bf16"].astype(ml_dtypes.bfloat16)
        .astype(np.float32))


def test_state_dicts_cross_both_ways_into_live_models(on_cpu, tmp_path):
    """A model's and an optimizer's state dicts saved by one package load
    into the other's model and optimizer: equal weights, equal forward."""
    rng = np.random.default_rng(3)
    jm, tm = _mlp(paddle_tpu), _mlp(port)
    jm.set_state_dict({k: rng.standard_normal(t.shape).astype("float32")
                       for k, t in jm.state_dict().items()})
    paddle_tpu.save(jm.state_dict(), str(tmp_path / "j.pdparams"))
    tm.set_state_dict(port.load(str(tmp_path / "j.pdparams")))
    x = rng.standard_normal((3, 4)).astype("float32")
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(),
                                      np.asarray(v._value))
    np.testing.assert_allclose(tm(port.to_tensor(x)).numpy(),
                               np.asarray(jm(paddle_tpu.to_tensor(x))._value),
                               rtol=1e-6, atol=1e-6)
    opt = port.optimizer.Adam(learning_rate=0.1, parameters=tm.parameters())
    tm(port.to_tensor(x)).sum().backward()
    opt.step()
    port.save(tm.state_dict(), str(tmp_path / "t.pdparams"))
    port.save(opt.state_dict(), str(tmp_path / "t.pdopt"))
    jm.set_state_dict(paddle_tpu.load(str(tmp_path / "t.pdparams")))
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(np.asarray(jm.state_dict()[k]._value),
                                      v.numpy())
    jopt = paddle_tpu.load(str(tmp_path / "t.pdopt"))
    assert jopt["@step"] == 1
    for k, v in opt.state_dict().items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(jopt[k]._value),
                                          v.numpy())


def test_port_import_stays_clear_of_the_jax_package():
    """The writer names the JAX package's class without importing it."""
    import ast
    import inspect

    from paddle_tpu_torch.framework import io_utils

    tree = ast.parse(inspect.getsource(io_utils))
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names} | {
        n.module for n in ast.walk(tree)
        if isinstance(n, ast.ImportFrom) and n.module}
    assert not any(m and m.split(".")[0] in ("jax", "paddle_tpu",
                                             "ml_dtypes")
                   for m in imported)


def test_port_files_load_in_the_port_bf16_included(on_cpu, tmp_path):
    """The port reads its own files: bf16 payloads as bf16 Tensors, a bare
    bf16 torch tensor as a Tensor too, bit for bit."""
    bf16 = torch.linspace(-3, 3, 12).reshape(3, 4).to(torch.bfloat16)
    port.save({"t": port.Tensor(bf16), "raw": bf16, "n": [bf16[0]]},
              str(tmp_path / "own.pdparams"))
    got = port.load(str(tmp_path / "own.pdparams"))
    for v in (got["t"], got["raw"], got["n"][0]):
        assert isinstance(v, port.Tensor) and v.dtype == torch.bfloat16
    assert torch.equal(got["t"]._value, bf16)
    assert torch.equal(got["raw"]._value, bf16)
    assert torch.equal(got["n"][0]._value, bf16[0])
