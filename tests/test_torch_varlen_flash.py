"""Packed varlen attention and the other entry points onto the flash
kernels (``flash_attn_unpadded``, the two qkvpacked forms,
``memory_efficient_attention``, ``sdp_kernel``) of the PyTorch port, held
against the JAX package's public functions on the same numpy inputs.

On CPU the JAX package runs its XLA routes (the segment mask for varlen,
``_sdpa_core`` for the rest); its gradients come through its own tape
(``stop_gradient=False``, ``backward()``). With one set of boundaries for q
and k the port runs the masked flash kernels' plain versions under the
document FlashMask: the same function on rows that attend at least one
key, which every row of a document does. Tolerances as in
``test_torch_flash_attention.py``: 2e-5 forward, 5e-5 gradients (f32 sums
in another order).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.incubate.nn import memory_efficient_attention as jax_mea
from paddle_tpu_torch.incubate.nn import memory_efficient_attention
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 2e-5
GRAD_TOL = 5e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x, grad=False):
    return torch.from_numpy(x).requires_grad_(grad)


def _p(x, grad=False):
    return paddle.to_tensor(x, stop_gradient=not grad)


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


@pytest.fixture
def masked_calls(monkeypatch):
    """Records every call the functionals make into the masked flash
    path."""
    calls = []
    real = tfa.flashmask_attention

    def spy(*a, **kw):
        calls.append(a[3])
        return real(*a, **kw)

    monkeypatch.setattr(tfa, "flashmask_attention", spy)
    return calls


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lens", [[96, 32, 128], [100, 60]])
def test_unpadded_matches_jax(masked_calls, lens, causal):
    cu = _cu(lens)
    total, scale = sum(lens), 1.0 / math.sqrt(32)
    q, k, v = (_rand((total, 4, 32), s) for s in (1, 2, 3))
    ref, _ = JF.flash_attn_unpadded(_p(q), _p(k), _p(v), _p(cu), _p(cu),
                                    max(lens), max(lens), scale=scale,
                                    causal=causal)
    got, none = TF.flash_attn_unpadded(_t(q), _t(k), _t(v),
                                       torch.from_numpy(cu),
                                       torch.from_numpy(cu.astype(np.int32)),
                                       max(lens), max(lens), scale=scale,
                                       causal=causal)
    assert none is None and got.shape == (total, 4, 32)
    assert TF.get_last_attention_backend() == "plain"
    assert len(masked_calls) == 1              # equal values: the masked path
    assert masked_calls[0].shape == (1, 1, total, 1 if causal else 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref._value),
                               atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_unpadded_gradients_match_jax(causal):
    lens = [100, 60]
    cu, total = _cu(lens), sum(lens)
    scale = 1.0 / math.sqrt(32)
    q, k, v, w = (_rand((total, 4, 32), s) for s in (4, 5, 6, 7))
    jq, jk, jv = _p(q, True), _p(k, True), _p(v, True)
    ref, _ = JF.flash_attn_unpadded(jq, jk, jv, _p(cu), _p(cu), 100, 100,
                                    scale=scale, causal=causal)
    (ref * _p(w)).sum().backward()
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    cu_t = torch.from_numpy(cu)
    out, _ = TF.flash_attn_unpadded(tq, tk, tv, cu_t, cu_t, 100, 100,
                                    scale=scale, causal=causal)
    (out * _t(w)).sum().backward()
    for got, want in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want.grad),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_mismatched_qk_boundaries_fall_back(masked_calls):
    """The twin of test_varlen_flash.py::test_mismatched_qk_boundaries_fall_back:
    different q and k boundaries must not take the masked path (it masks by
    k's documents only); the segment route intersects seg_q == seg_k."""
    total, scale = 256, 1.0 / math.sqrt(32)
    q = _rand((total, 4, 32), 8)
    cu_q = np.array([0, 64, 256], "int64")
    cu_k = np.array([0, 128, 256], "int64")
    out, _ = TF.flash_attn_unpadded(_t(q), _t(q), _t(q),
                                    torch.from_numpy(cu_q),
                                    torch.from_numpy(cu_k), 192, 128,
                                    scale=scale, causal=False)
    assert TF.get_last_attention_backend() == "plain" and not masked_calls
    seg_q = np.searchsorted(cu_q[1:-1], np.arange(total), side="right")
    seg_k = np.searchsorted(cu_k[1:-1], np.arange(total), side="right")
    scores = np.einsum("qhd,khd->hqk", q, q) * scale
    scores = np.where((seg_q[:, None] == seg_k[None, :])[None], scores,
                      -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    want = np.einsum("hqk,khd->qhd", p / p.sum(-1, keepdims=True), q)
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-3, atol=2e-3)
    ref, _ = JF.flash_attn_unpadded(_p(q), _p(q), _p(q), _p(cu_q), _p(cu_k),
                                    192, 128, scale=scale, causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref._value),
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_causal_segment_route_matches_jax():
    """Different totals for q and k (cross attention over packed
    documents): the causal segment route, against JAX's."""
    q = _rand((48, 2, 16), 9)
    kv = _rand((40, 2, 16), 10)
    cu_q, cu_k = np.array([0, 30, 48]), np.array([0, 25, 40])
    ref, _ = JF.flash_attn_unpadded(_p(q), _p(kv), _p(kv), _p(cu_q),
                                    _p(cu_k), 30, 25, scale=0.25, causal=True)
    got, _ = TF.flash_attn_unpadded(_t(q), _t(kv), _t(kv), cu_q, cu_k, 30,
                                    25, scale=0.25, causal=True)
    assert TF.get_last_attention_backend() == "plain"
    np.testing.assert_allclose(got.numpy(), np.asarray(ref._value),
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_one_boundaries_object_skips_the_value_comparison(monkeypatch):
    cu = torch.tensor([0, 5, 16])
    monkeypatch.setattr(torch, "equal", None)        # never reached
    q = _t(_rand((16, 2, 16), 11))
    out, _ = TF.flash_attn_unpadded(q, q, q, cu, cu, 11, 11, scale=0.25,
                                    causal=True)
    assert out.shape == q.shape


def test_varlen_dropout_raises():
    q = _t(_rand((16, 2, 16), 12))
    cu = torch.tensor([0, 16])
    with pytest.raises(NotImplementedError, match="dropout"):
        TF.flash_attn_unpadded(q, q, q, cu, cu, 16, 16, 0.25, dropout=0.1)


# JAX's two qkvpacked forms raise AttributeError (``extra.py`` imports the
# function ``flash_attention`` where it means the module, ROADMAP C): the
# port is held to what they mean, JAX's ``flash_attention`` and
# ``flash_attn_unpadded`` on the three parts of the packed tensor.
@pytest.mark.parametrize("causal", [True, False])
def test_qkvpacked_matches_jax(causal):
    qkv = _rand((2, 40, 3, 4, 16), 13)
    w = _rand((2, 40, 4, 16), 14)
    jx = _p(qkv, True)
    ref, _ = JF.flash_attention(jx[:, :, 0], jx[:, :, 1], jx[:, :, 2],
                                causal=causal)
    (ref * _p(w)).sum().backward()
    tx = _t(qkv, True)
    got, none = TF.flash_attn_qkvpacked(tx, causal=causal)
    (got * _t(w)).sum().backward()
    assert none is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref._value),
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_varlen_qkvpacked_matches_jax(causal):
    lens = [50, 14, 36]
    cu, total = _cu(lens), sum(lens)
    qkv = _rand((total, 3, 4, 16), 15)
    w = _rand((total, 4, 16), 16)
    jx = _p(qkv, True)
    ref, _ = JF.flash_attn_unpadded(jx[:, 0], jx[:, 1], jx[:, 2], _p(cu),
                                    _p(cu), 50, 50, scale=0.25,
                                    causal=causal)
    (ref * _p(w)).sum().backward()
    tx = _t(qkv, True)
    cu_t = torch.from_numpy(cu)
    got, _ = TF.flash_attn_varlen_qkvpacked(tx, cu_t, cu_t, 50, 50,
                                            causal=causal)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref._value),
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("bias,scale", [(None, None), ("causal", None),
                                        (None, 0.3), ("causal", 0.125),
                                        ("tensor", None), ("tensor", 0.2)])
def test_memory_efficient_attention_matches_jax(bias, scale):
    B, S, H, D = 2, 24, 2, 16
    q, k, v = (_rand((B, S, H, D), s) for s in (17, 18, 19))
    b = _rand((1, H, S, S), 20) if bias == "tensor" else bias
    ref = jax_mea(_p(q), _p(k), _p(v),
                  attn_bias=_p(b) if bias == "tensor" else b, scale=scale,
                  training=False)
    got = memory_efficient_attention(
        _t(q), _t(k), _t(v), attn_bias=_t(b) if bias == "tensor" else b,
        scale=scale, training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref._value),
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_memory_efficient_attention_refuses_dropout_and_other_strings():
    """Dropout is ported (the plain route, or the bias route's f32
    probabilities, dropped with the port's mask); a bias string other than
    "causal" is refused."""
    q = _t(_rand((1, 8, 2, 16), 21))
    assert memory_efficient_attention(q, q, q, p=0.1).shape == q.shape
    assert TF.get_last_attention_backend() == "plain"
    out = memory_efficient_attention(q, q, q, attn_bias=torch.zeros(8, 8),
                                     p=0.1)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="causal"):
        memory_efficient_attention(q, q, q, attn_bias="upper")


def test_sdp_kernel_switches_the_flash_path_off(monkeypatch, masked_calls):
    q = _rand((2, 20, 2, 16), 22)
    kernel_calls = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **kw: kernel_calls.append(1))
    ref = JF.flash_attention(_p(q), _p(q), _p(q), causal=True)[0]
    cu = torch.tensor([0, 12, 20])
    with TF.sdp_kernel(enable_flash=False):
        out, _ = TF.flash_attention(_t(q), _t(q), _t(q), causal=True)
        assert TF.get_last_attention_backend() == "plain"
        TF.flash_attn_unpadded(_t(q[0]), _t(q[0]), _t(q[0]), cu, cu, 12, 12,
                               scale=0.25, causal=True)
        TF.flashmask_attention(_t(q), _t(q), _t(q),
                               torch.full((2, 1, 20, 1), 20), causal=True)
    assert not kernel_calls and not masked_calls
    np.testing.assert_allclose(out.numpy(), np.asarray(ref._value),
                               atol=FWD_TOL, rtol=FWD_TOL)
    TF.flash_attention(_t(q), _t(q), _t(q), causal=True)   # restored
    assert kernel_calls == [1]
