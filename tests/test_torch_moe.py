"""MoE on one device (``incubate.distributed.models.moe``) of the port
against the JAX package on the CPU: ``tests/test_moe.py``'s single-device
bodies on both packages with the same weights (routing against the numpy
reference, the balance loss, capacity drops, gradients, ``to_static``,
index dispatch against dense, training through ``TrainStep`` with the
gate's ``l_aux`` in the objective), the port's outputs and gradients held
to JAX's, ``recompute_interval`` against none (bit-equal), and the raises
of the groups: ``mp_group`` (JAX never reads it: ROADMAP C) and a
``moe_group`` that does not tile the world. The mesh bodies are in
``test_torch_expert_parallel.py``.
Tolerances: f32 outputs and gradients within 1e-5 relative and 1e-6
absolute of JAX's (sums in another order); index against dense within
2^-20 of the tensor's largest magnitude (the combine's products are
rounded by a multiply-add in the dense one-hot product and by a product
then a sum in the gather, so the two are not bit-equal); TrainStep losses
within 1e-5 relative over 10 steps.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from port_bodies import jax_results, npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])
TOL = dict(rtol=1e-5, atol=1e-6)
D, E, T = 8, 4, 32


def _moe(P):
    return P.incubate.distributed.models.moe


def _scale_expert(P, scale):
    nn = P.nn
    fc = nn.Linear(D, D)
    fc.set_state_dict({"weight": np.eye(D, dtype="float32") * scale,
                       "bias": np.zeros(D, "float32")})
    return fc


def _set(layer, seed):
    rng = np.random.default_rng(seed)
    layer.set_state_dict({k: (rng.standard_normal(tuple(v.shape)) * 0.3)
                          .astype("float32")
                          for k, v in sorted(layer.state_dict().items())})


def _numpy_moe_reference(x, gate_w, k, capacity, scales):
    logits = x @ gate_w
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs = probs / probs.sum(1, keepdims=True)
    T_, E_ = probs.shape
    masked = probs.copy()
    sel = []
    for _ in range(k):
        idx = masked.argmax(1)
        sel.append((idx, probs[np.arange(T_), idx]))
        masked[np.arange(T_), idx] = 0.0
    if k > 1:
        denom = sum(g for _, g in sel) + 1e-9
        sel = [(i, g / denom) for i, g in sel]
    counts = np.zeros(E_, np.int64)
    out = np.zeros_like(x)
    for idx, g in sel:
        for t in range(T_):
            if counts[idx[t]] < capacity:
                out[t] += g[t] * scales[idx[t]] * x[t]
            counts[idx[t]] += 1
    return out, probs


def _routing_body(gate_name, k):
    def body(P):
        moe = _moe(P)
        scales = [float(i + 1) for i in range(E)]
        gate = getattr(moe, gate_name)(D, E, capacity=(100.0, 100.0))
        _set(gate, 0)
        layer = moe.MoELayer(D, [_scale_expert(P, s) for s in scales],
                             gate=gate)
        x = np.random.RandomState(0).randn(T, D).astype("float32")
        out = npy(layer(P.to_tensor(x)))
        ref, probs = _numpy_moe_reference(x, npy(gate.weight), k, T, scales)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        top1 = np.zeros((T, E), np.float32)
        top1[np.arange(T), probs.argmax(1)] = 1
        aux = E * np.sum(probs.mean(0) * top1.mean(0))
        np.testing.assert_allclose(float(layer.l_aux), aux, rtol=1e-5)
        assert float(gate.get_loss()) == pytest.approx(aux, rel=1e-5)
        assert gate.get_loss() is None
        return {"out": out, "aux": np.array([float(layer.l_aux)], np.float32)}
    body.__name__ = f"routing_{gate_name}"
    return body


ROUTING = {g: _routing_body(g, k) for g, k in (("SwitchGate", 1),
                                              ("GShardGate", 2))}


@pytest.fixture(scope="module")
def jax_routing():
    """JAX's routing answers for both gates, computed once before the
    tests (``jax_results`` keeps them): the JAX legs' eager programs
    compile per op, which belongs to setup, not to a test's call."""
    return {g: jax_results(body) for g, body in ROUTING.items()}


@PKG
@pytest.mark.parametrize("gate", sorted(ROUTING))
def test_moe_routing_matches_dense_reference(pkg, gate, on_cpu, jax_routing):
    run(ROUTING[gate], pkg, **TOL)


def _drop_body(P):
    moe = _moe(P)
    gate = moe.SwitchGate(D, E, capacity=(0.25, 0.25))   # capacity 2
    _set(gate, 1)
    layer = moe.MoELayer(D, [_scale_expert(P, 1.0) for _ in range(E)],
                         gate=gate)
    x = np.random.RandomState(1).randn(T, D).astype("float32")
    out = npy(layer(P.to_tensor(x)))
    dropped = int(np.sum(np.all(out == 0, axis=1)))
    assert dropped > 0
    return {"out": out, "dropped": dropped}


@PKG
def test_moe_capacity_drops_tokens(pkg, on_cpu):
    run(_drop_body, pkg, **TOL)


def _experts(P, n=E, seed=2):
    nn = P.nn
    experts = [nn.Sequential(nn.Linear(D, 2 * D), nn.GELU(),
                             nn.Linear(2 * D, D)) for _ in range(n)]
    for i, e in enumerate(experts):
        _set(e, seed + i)
    return experts


def _grads_body(gate_name, mode):
    def body(P):
        moe = _moe(P)
        layer = moe.MoELayer(D, _experts(P), gate=gate_name,
                             dispatch_mode=mode)
        _set(layer.gate, 9)
        x = P.to_tensor(np.random.RandomState(2).randn(T, D).astype(
            "float32"), stop_gradient=False)
        out = layer(x)
        (out.sum() + layer.l_aux * 0.01).backward()
        res = {"out": npy(out), "gx": npy(x.grad),
               "g_gate": npy(layer.gate.weight.grad),
               "aux": np.array([float(layer.l_aux)], np.float32)}
        for i, e in enumerate(layer.experts):
            for name, p in e.named_parameters():
                res[f"g{i}_{name}"] = npy(p.grad)
        assert np.abs(res["g_gate"]).sum() > 0
        return res
    body.__name__ = f"grads_{gate_name}_{mode}"
    return body


GRADS = {(g, m): _grads_body(g, m) for g in ("gshard", "switch", "naive")
         for m in ("index", "dense")}


@pytest.fixture(scope="module", params=sorted(GRADS), ids="-".join)
def grads_case(request):
    """A gradient body with JAX's answer computed in the setup."""
    jax_results(GRADS[request.param])
    return request.param


def test_moe_outputs_and_grads_equal_jax(grads_case, on_cpu):
    run(GRADS[grads_case], "torch", rtol=1e-5, atol=1e-6)


def test_index_dispatch_matches_dense(on_cpu):
    """The gather / scatter path against the one-hot einsums, the same
    decisions, in the port: outputs, l_aux (equal) and every gradient."""
    for gate in ("gshard", "switch", "naive"):
        a = GRADS[(gate, "index")](paddle_tpu_torch)
        b = GRADS[(gate, "dense")](paddle_tpu_torch)
        np.testing.assert_array_equal(a["aux"], b["aux"])
        for key in b:
            lim = 2.0 ** -20 * max(float(np.abs(b[key]).max()), 1e-30)
            assert float(np.abs(a[key] - b[key]).max()) <= lim, (gate, key)


def test_moe_to_static_parity(on_cpu):
    P = paddle_tpu_torch
    moe = _moe(P)
    layer = moe.MoELayer(D, [_scale_expert(P, float(i + 1))
                             for i in range(E)], gate="switch")
    x = P.to_tensor(np.random.RandomState(3).randn(T, D).astype("float32"))
    eager = npy(layer(x))
    out = npy(P.jit.to_static(layer)(x))
    np.testing.assert_array_equal(out, eager)


def test_recompute_interval_equals_none(on_cpu):
    P = paddle_tpu_torch
    moe = _moe(P)
    outs = []
    for interval in (0, 1):
        layer = moe.MoELayer(D, _experts(P), gate="gshard",
                             recompute_interval=interval)
        _set(layer.gate, 9)
        x = P.to_tensor(np.random.RandomState(2).randn(T, D).astype(
            "float32"), stop_gradient=False)
        out = layer(x)
        out.sum().backward()
        outs.append([npy(out), npy(x.grad)] + [
            npy(p.grad) for p in layer.parameters()])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_mesh_groups_raise(on_cpu):
    moe = _moe(paddle_tpu_torch)

    class _Group:
        nranks, rank, ranks = 3, 0, [0, 1, 2]

    with pytest.raises(ValueError, match="does not tile"):
        moe.MoELayer(D, _experts(paddle_tpu_torch, 2), moe_group=_Group())
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        moe.MoELayer(D, _experts(paddle_tpu_torch, 2), mp_group=object())


def _trains_body(P):
    nn = P.nn
    moe = _moe(P)

    class M(nn.Layer):
        def __init__(self):
            super().__init__()
            self.moe = moe.MoELayer(D, _experts(P), gate="gshard")
            self.head = nn.Linear(D, 4)

        def forward(self, x):
            return self.head(self.moe(x))

    m = M()
    _set(m, 5)
    opt = P.optimizer.AdamW(learning_rate=3e-3, parameters=m.parameters())
    lf = nn.CrossEntropyLoss()
    if P is paddle_tpu:
        from paddle_tpu.jit.train import TrainStep
    else:
        from paddle_tpu_torch.jit import TrainStep
    step = TrainStep(m, lambda o, y: lf(o, y)
                     + m.moe.gate.get_loss(clear=False), opt)
    rs = np.random.RandomState(0)
    x = P.to_tensor(rs.randn(T, D).astype("float32"))
    y = P.to_tensor(rs.randint(0, 4, T).astype("int64"))
    losses = np.array([float(step(x, y)) for _ in range(10)], np.float32)
    assert losses[-1] < losses[0]
    return {"losses": losses}


@PKG
def test_index_dispatch_trains(pkg, on_cpu):
    run(_trains_body, pkg, rtol=1e-5, atol=1e-6)
