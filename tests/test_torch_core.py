"""The port's core beside the op tables: ``auto_cast(level="O2")`` through
the op layer (one op per list, against the JAX package under its O2), the
flags, dtypes and places, ``jacobian`` / ``hessian`` against JAX, the
saved-tensor hooks, and the random ops held to distribution pins (the two
frameworks give different numbers from one seed, so no bit identity).

O2 tolerances: bf16 outputs are compared in float32 at 2^-7 relative (both
sides round the inputs and the output to bf16; the products sum in f32 in
another order), f32 outputs at 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as port
from port_bodies import dname, on_cpu  # noqa: F401

RNG = np.random.default_rng(11)
A = RNG.standard_normal((4, 8)).astype(np.float32)
B = RNG.standard_normal((8, 3)).astype(np.float32)


def _np(t):
    if isinstance(t, port.Tensor):
        return t.numpy()
    v = t._value
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)


# op name -> (call on a package, the list it is on)
O2_CASES = {
    "matmul": (lambda P, a, b: P.matmul(a, b), "white"),
    "exp": (lambda P, a, b: P.exp(a), "black"),
    "mean": (lambda P, a, b: P.mean(a, axis=1), "black"),
    "tanh": (lambda P, a, b: P.tanh(a), "other"),
    "add": (lambda P, a, b: P.add(a, a), "other"),
}


@pytest.mark.parametrize("op", sorted(O2_CASES))
def test_o2_casts_every_op_but_the_black_list_as_jax_does(on_cpu, op):
    fn, kind = O2_CASES[op]
    outs = {}
    for name, P in (("jax", paddle_tpu), ("torch", port)):
        with P.amp.auto_cast(level="O2", dtype="bfloat16"):
            outs[name] = fn(P, P.to_tensor(A), P.to_tensor(B))
    assert dname(outs["torch"]) == dname(outs["jax"])
    assert dname(outs["torch"]) == ("float32" if kind == "black"
                                    else "bfloat16")
    got, want = _np(outs["torch"]), _np(outs["jax"])
    if kind == "black":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)
    with port.amp.auto_cast(level="O1"):       # O1 casts the white list only
        o1 = fn(port, port.to_tensor(A), port.to_tensor(B))
    assert dname(o1) == {"white": "bfloat16", "black": "float32",
                         "other": "float32"}[kind]


def test_o2_gradients_come_back_in_the_input_dtype(on_cpu):
    a = port.to_tensor(A, stop_gradient=False)
    with port.amp.auto_cast(level="O2"):
        y = port.matmul(a, port.to_tensor(B)).sum()
    y.backward()
    assert dname(a.grad) == "float32"
    np.testing.assert_allclose(a.grad.numpy(),
                               np.broadcast_to(B.sum(1), (4, 8)),
                               rtol=2 ** -7, atol=2 ** -6)


def test_a_model_forward_under_o2_still_raises():
    """Since the models cast at seams of JAX's op names, O2 reaches a
    model's forward instead of raising: over f32 weights every op but the
    black list runs in bf16, so the logits are bf16
    (``test_torch_amp_o2.py`` holds the dtypes and values to JAX)."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny

    m = GPTForCausalLM(gpt_tiny(), device="cpu").eval()
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with port.amp.auto_cast(level="O2"):
        logits = m(ids)
    assert logits.dtype == torch.bfloat16
    assert m(ids).dtype == torch.float32


def test_flags(on_cpu):
    assert port.get_flags("FLAGS_check_nan_inf") == {
        "FLAGS_check_nan_inf": False}
    with pytest.raises(ValueError):
        port.set_flags({"FLAGS_no_such_flag": 1})
    port.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="'log'"):
            port.log(port.to_tensor([-1.0]))
        port.set_flags({"FLAGS_check_nan_inf_level": 1})
        with pytest.warns(UserWarning, match="NaN/Inf"):
            port.log(port.to_tensor([-1.0]))
    finally:
        port.set_flags({"FLAGS_check_nan_inf": False,
                        "FLAGS_check_nan_inf_level": 0})
    prev = torch.get_float32_matmul_precision()
    try:
        port.set_flags({"FLAGS_matmul_precision": "high"})
        assert torch.get_float32_matmul_precision() == "high"
        port.set_flags({"FLAGS_matmul_precision": "default"})
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision(prev)
    try:
        port.set_flags({"FLAGS_cudnn_deterministic": True})
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        port.set_flags({"FLAGS_cudnn_deterministic": False})
    assert set(port.get_flags()) == set(paddle_tpu.get_flags())


def test_dtypes_and_places(on_cpu):
    from paddle_tpu_torch.framework import dtype as D

    for name in ("bool", "uint8", "int8", "int16", "int32", "int64",
                 "float16", "bfloat16", "float32", "float64", "complex64"):
        assert D.dtype_to_str(D.convert_dtype(name)) == name
        assert D.convert_dtype(np.dtype(name) if name != "bfloat16"
                               else "bf16") == getattr(port, name)
    assert port.finfo("float32").eps == np.finfo(np.float32).eps
    assert port.iinfo(port.int32).max == np.iinfo(np.int32).max
    prev = port.get_default_dtype()
    try:
        port.set_default_dtype("float64")
        assert dname(port.to_tensor([1.5])) == "float64"
        assert dname(port.ones([2])) == "float64"
        with pytest.raises(TypeError):
            port.set_default_dtype("int32")
    finally:
        port.set_default_dtype(prev)
    assert port.get_device() == "cpu"
    assert port.CPUPlace() == port.to_tensor([1]).place
    assert port.CPUPlace().is_cpu_place()
    assert port.is_compiled_with_cuda() == (torch.version.cuda is not None)


def test_jacobian_and_hessian_match_jax(on_cpu):
    x = RNG.standard_normal(3)

    def f(P):
        return lambda t: P.tanh(t) * t.sum()

    def g(P):
        return lambda t: (P.exp(t) * t).sum()

    for name, P in (("jax", paddle_tpu), ("torch", port)):
        jac = P.autograd.jacobian(f(P), P.to_tensor(x))
        hes = P.autograd.hessian(g(P), P.to_tensor(x))
        t = P.to_tensor(x, stop_gradient=False)
        jt = P.autograd.jacobian(f(P)(t), t)
        if name == "jax":
            want = [_np(jac), _np(hes), _np(jt)]
        else:
            for got, w in zip((jac, hes, jt), want):
                np.testing.assert_allclose(got.numpy(), w, rtol=1e-12,
                                           atol=1e-12)


def test_saved_tensors_hooks_see_the_pylayer_saves(on_cpu):
    packed = []

    class Square(port.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x, x + 1

        @staticmethod
        def backward(ctx, g1, g2):
            (x,) = ctx.saved_tensor()
            return 2 * x * g1 + g2

    def pack(t):
        packed.append(t.shape)
        return t

    x = port.to_tensor([1.0, 3.0], stop_gradient=False)
    with port.autograd.saved_tensors_hooks(pack, lambda t: t):
        y, z = Square.apply(x)
    (y.sum() + z.sum()).backward()
    assert [2] in packed
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 7.0])


def test_random_ops_meet_their_distributions(on_cpu):
    """Moments within 5 standard errors, a chi-square over 10 uniform
    bins below its 0.999 quantile (27.9 for 9 dof), integers in range,
    a permutation, and seeded repeatability."""
    n = 20000
    port.seed(7)
    u = port.uniform([n], min=-2.0, max=3.0).numpy()
    assert abs(u.mean() - 0.5) < 5 * (5 / np.sqrt(12)) / np.sqrt(n)
    counts = np.histogram(u, bins=10, range=(-2, 3))[0]
    assert ((counts - n / 10) ** 2 / (n / 10)).sum() < 27.9
    z = port.randn([n]).numpy()
    assert abs(z.mean()) < 5 / np.sqrt(n) and abs(z.std() - 1) < 0.03
    nm = port.normal(2.0, 3.0, shape=[n]).numpy()
    assert abs(nm.mean() - 2) < 5 * 3 / np.sqrt(n)
    r = port.randint(3, 9, [n]).numpy()
    assert r.min() == 3 and r.max() == 8 and dname(port.randint(3, 9)) == \
        "int64"
    assert sorted(port.randperm(50).numpy().tolist()) == list(range(50))
    b = port.bernoulli(port.full([n], 0.3)).numpy()
    assert abs(b.mean() - 0.3) < 5 * np.sqrt(0.21 / n)
    m = port.multinomial(port.to_tensor([0.0, 1.0, 3.0]), 2000,
                         replacement=True).numpy()
    assert (m != 0).all() and abs((m == 2).mean() - 0.75) < 0.05
    e = port.zeros([n]).exponential_(2.0).numpy()
    assert abs(e.mean() - 0.5) < 5 * 0.5 / np.sqrt(n)
    port.seed(7)
    again = port.uniform([n], min=-2.0, max=3.0).numpy()
    np.testing.assert_array_equal(u, again)
