"""``jit.to_static``, ``jit.save`` / ``jit.load`` (``TranslatedLayer``) and
``inference.create_predictor`` of the port against the JAX package, on
the CPU.

``tests/test_jit_save_load.py``'s bodies run on both packages
(``port_bodies.run``: the port's outputs within 1e-5 of the JAX
package's on the same weights, set from numpy): a replay in the same
process at two batch sizes (the ``None`` dim is symbolic in both
exports), the weights-only save that raises when called, the predictor's
positional and handle APIs, the predictor's refusal of a weights-only
artifact, ``InputSpec``'s helpers. The port's export is also served by a
fresh process that imports only the port. ``gpt_tiny()`` exported by both
packages (the port's program holds the flash forward operator) and run
through each package's ``Predictor``: logits within 1e-5 of each other.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as port
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.models import gpt as tgpt
from port_bodies import npy, on_cpu, run  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _model(paddle):
    nn = paddle.nn
    m = nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.Linear(16, 3))
    rng = np.random.default_rng(11)
    m.set_state_dict({k: (rng.standard_normal(t.shape) * 0.5)
                      .astype("float32") for k, t in m.state_dict().items()})
    m.eval()
    return m


def _x(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 8)).astype(
        "float32")


def _spec(paddle):
    return [paddle.static.InputSpec([None, 8], "float32")]


def replay_same_process(paddle):
    m = _model(paddle)
    path = os.path.join(tempfile.mkdtemp(), "m")
    paddle.jit.save(m, path, input_spec=_spec(paddle))
    loaded = paddle.jit.load(path)
    out = {}
    for n, seed in ((4, 0), (9, 1), (1, 2)):
        x = paddle.to_tensor(_x(n, seed))
        got, ref = npy(loaded(x)), npy(m(x))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        out[f"b{n}"] = got
    with open(path + ".pdmodel.meta", "rb") as f:
        meta = pickle.load(f)
    out["has_program"] = meta["has_program"]
    out["state_keys"] = sorted(meta["state_keys"])
    return out


def weights_only_save(paddle):
    m = _model(paddle)
    path = os.path.join(tempfile.mkdtemp(), "w")
    paddle.jit.save(m, path)
    loaded = paddle.jit.load(path)
    with pytest.raises(RuntimeError, match="without a serialized program"):
        loaded(paddle.to_tensor(np.zeros((1, 8), "float32")))
    m2 = _model(paddle)
    m2.set_state_dict({k: np.zeros(t.shape, "float32")
                       for k, t in m2.state_dict().items()})
    m2.set_state_dict(loaded.state_dict())
    x = paddle.to_tensor(np.ones((2, 8), "float32"))
    return {"out": npy(m2(x)), "keys": sorted(loaded.state_dict())}


def predictor_api(paddle):
    m = _model(paddle)
    path = os.path.join(tempfile.mkdtemp(), "pred")
    paddle.jit.save(m, path, input_spec=_spec(paddle))
    inference = paddle.inference
    predictor = inference.create_predictor(inference.Config(path))
    x = _x(6, 3)
    outs = predictor.run([x])
    names = predictor.get_input_names()
    predictor.get_input_handle(names[0]).copy_from_cpu(x)
    predictor.run()
    out_h = predictor.get_output_handle(predictor.get_output_names()[0])
    np.testing.assert_allclose(out_h.copy_to_cpu(), outs[0], rtol=1e-6)
    return {"out": outs[0], "names": names,
            "out_names": predictor.get_output_names()}


def predictor_requires_program(paddle):
    path = os.path.join(tempfile.mkdtemp(), "noprog")
    paddle.jit.save(_model(paddle), path)
    with pytest.raises(ValueError, match="no serialized program"):
        paddle.inference.create_predictor(paddle.inference.Config(path))
    return {}


def input_spec_helpers(paddle):
    spec = paddle.static.InputSpec([None, 4], "float32", name="x")
    t = paddle.to_tensor(np.zeros((2, 3), "int32"))
    s = paddle.static.InputSpec.from_tensor(t)
    return {"batch": spec.batch(8).shape, "unbatch": spec.unbatch().shape,
            "from_tensor": s.shape, "dtype": str(s.dtype).split(".")[-1],
            "name": spec.name}


def to_static_eager_equal(paddle):
    m = _model(paddle)
    fn = paddle.jit.to_static(m)
    x = paddle.to_tensor(_x(5, 4))
    got = npy(fn(x))
    paddle.jit.enable_to_static(False)
    try:
        off = npy(fn(x))
    finally:
        paddle.jit.enable_to_static(True)

    @paddle.jit.to_static
    def f(a, b):
        return a * 2 + b

    both = npy(f(x, x))
    np.testing.assert_allclose(got, off, rtol=1e-6)
    return {"layer": got, "fn": both, "is_layer": fn.layer is m}


BODIES = [replay_same_process, weights_only_save, predictor_api,
          predictor_requires_program, input_spec_helpers,
          to_static_eager_equal]


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_jit_body(on_cpu, body, pkg):
    run(body, pkg)


@pytest.fixture(scope="module")
def served_in_a_fresh_process(tmp_path_factory):
    """A port export run by a fresh process that imports the port only
    (run once: the process's start is most of it): its result."""
    tmp = tmp_path_factory.mktemp("served")
    prev = port.framework.device._current["place"]
    port.set_device("cpu")
    try:
        m = _model(port)
        x = _x(5, 2)
        np.save(tmp / "x.npy", x)
        np.save(tmp / "ref.npy", m(port.to_tensor(x)).numpy())
        path = str(tmp / "srv")
        port.jit.save(m, path, input_spec=_spec(port))
    finally:
        port.framework.device._current["place"] = prev
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import paddle_tpu_torch as paddle
        x = np.load({str(tmp / 'x.npy')!r})
        ref = np.load({str(tmp / 'ref.npy')!r})
        cfg = paddle.inference.Config({path!r})
        cfg.disable_gpu()
        out = paddle.inference.create_predictor(cfg).run([x])[0]
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "paddle_tpu")]
        assert not bad, bad
        print("SERVED_OK")
    """)
    return subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=240)


def test_export_is_served_by_a_fresh_process_without_the_class(
        served_in_a_fresh_process):
    """The reference contract: execute without the model class, in a
    process that imports the port and nothing of the JAX package (on the
    CPU: ``Config.disable_gpu()``), with the exporting process's
    outputs."""
    r = served_in_a_fresh_process
    assert r.returncode == 0 and "SERVED_OK" in r.stdout, (r.stdout,
                                                           r.stderr)


GPT = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
           max_position=128)


@pytest.fixture(scope="module")
def jax_gpt_export():
    """gpt_tiny exported by the JAX package and run through its Predictor
    at B 3 and 2 (computed once): the weights and the logits."""
    from paddle_tpu.models import gpt as jgpt

    with paddle_tpu.utils.unique_name.guard():
        paddle_tpu.seed(5)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**GPT))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    ids = np.random.default_rng(5).integers(0, 1024, (3, 32))
    outs = []
    for n in (3, 2):    # the JAX GPT's export takes no symbolic batch
        path = os.path.join(tempfile.mkdtemp(), "jgpt")
        paddle_tpu.jit.save(jm, path, input_spec=[
            paddle_tpu.static.InputSpec([n, 32], "int64")])
        pred = paddle_tpu.inference.create_predictor(
            paddle_tpu.inference.Config(path))
        outs.append(pred.run([ids[:n]])[0])
    return state, ids, outs


def test_gpt_tiny_export_served_equal_to_jax(on_cpu, jax_gpt_export,
                                             tmp_path):
    from paddle_tpu_torch.ops import flash_attention as fa

    state, ids, want = jax_gpt_export
    net = from_paddle_tpu_state(state, tgpt.GPTConfig(**GPT),
                                device="cpu").eval()
    path = str(tmp_path / "tgpt")
    port.jit.save(net, path, input_spec=[port.static.InputSpec([None, 32],
                                                               "int64")])
    ep = torch.export.load(path + ".pdmodel")
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert sum("paddle_tpu_torch.flash_fwd" in o for o in ops) == 2
    cfg = port.inference.Config(path)
    cfg.disable_gpu()
    pred = port.inference.create_predictor(cfg)
    calls = []
    real = fa.flash_attention_fwd_ref

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    fa.flash_attention_fwd_ref = counted
    try:
        got = [pred.run([ids[:n]])[0] for n in (3, 2)]
    finally:
        fa.flash_attention_fwd_ref = real
    assert len(calls) == 2 * 2              # each layer, each run
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    with open(path + ".pdmodel.meta", "rb") as f:
        meta = pickle.load(f)
    # the weights are stored once: the program holds none of them
    assert meta["program_nbytes"] < sum(v.nbytes for v in state.values())


def test_to_static_over_a_torch_module_and_a_method(on_cpu):
    net = from_paddle_tpu_state(
        {k: np.asarray(v) for k, v in _gpt_state().items()},
        tgpt.GPTConfig(**GPT), device="cpu").eval()
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 1024,
                                                            (2, 16)))
    fn = port.jit.to_static(net)
    with torch.no_grad():
        assert torch.equal(fn(ids), net(ids))
        bound = port.jit.to_static(net.forward)
        assert bound.layer is net and torch.equal(bound(ids), net(ids))
    assert (fn.captures, fn.replays) == (0, 0)     # eager on the CPU
    def helper(a):
        return a

    assert port.jit.not_to_static(helper) is helper and helper._jit_skip
    port.jit.set_verbosity(2)
    port.jit.set_code_level(50)
    assert "def forward" in fn.code



class _Ramp(port.nn.Layer):
    """No parameters: its input's device is all it has."""

    def forward(self, x):
        return x * 2.0 + 1.0


def test_parameter_free_layer_takes_the_current_place(on_cpu):
    """A parameter-free layer with no tensor input builds on the current
    place (``get_place``), not on a fixed CPU: here the place is the CPU,
    and a place of the card raises on a machine without one instead of
    falling back (``on_cpu`` restores the place)."""
    fn = port.jit.to_static(_Ramp())
    assert fn._device([]) == torch.device("cpu")
    path = os.path.join(tempfile.mkdtemp(), "ramp")
    port.jit.save(_Ramp(), path, input_spec=[
        port.static.InputSpec([None, 4], "float32")])
    loaded = port.jit.load(path)
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    np.testing.assert_array_equal(npy(loaded(port.to_tensor(x))),
                                  x * 2.0 + 1.0)
    if not torch.cuda.is_available():
        from paddle_tpu_torch.framework import device as pdev

        pdev._current["place"] = None       # no place set: the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn._device([])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.jit.save(_Ramp(), path + "2", input_spec=[
                port.static.InputSpec([None, 4], "float32")])

def _gpt_state():
    from paddle_tpu.models import gpt as jgpt

    with paddle_tpu.utils.unique_name.guard():
        paddle_tpu.seed(6)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**GPT))
    return jm.gpt.raw_state()
