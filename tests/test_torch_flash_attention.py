"""Flash attention of the PyTorch port held against the JAX package's plain
path on the same numpy inputs.

The JAX Pallas flash kernels cannot serve as the CPU reference under this
jax (``_no_x64`` imports ``jax.experimental.enable_x64``), so the port is
held against ``_sdpa_core`` and ``jax.grad`` of it, with the tolerances of
``tests/test_pallas_flash_attention.py``: 2e-5 on the forward (f32 sums in
another order), 5e-5 on the gradients. On CPU tensors the port's wrapper
runs the kernels' plain versions, so these tests check the forward and the
explicit backward formulas (``ds = p (dp - delta) scale``, ``dq = ds k``,
``dk = ds^T q``, ``dv = p^T dO``) that the CUDA kernels compute; the kernels
themselves are held against the same plain versions on the card in
``test_torch_cuda_kernels.py``.

``kernel_tolerance`` is checked here too: an emulation of the bf16 kernel's
rounding (online softmax over 64-column tiles, f64 sums) stays within it,
and a causal mask one column too wide does not.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional.flash_attention import _sdpa_core
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 2e-5
GRAD_TOL = 5e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_naive(q, k, v, causal):
    return _sdpa_core(q, k, v, None, 1.0 / math.sqrt(q.shape[-1]), causal,
                      0.0, False)


def _t(x, dtype=torch.float32, grad=False):
    return torch.from_numpy(x).to(dtype).requires_grad_(grad)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [64, 37])
def test_forward_matches_jax_sdpa(causal, S):
    B, H, D = 2, 3, 16
    q, k, v = (_rand((B, S, H, D), s) for s in (0, 1, 2))
    ref = np.asarray(_jax_naive(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, atol=FWD_TOL, rtol=FWD_TOL)
    out, _ = TF.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_single_kv_head_matches_jax(causal):
    B, S, H, D = 2, 40, 4, 16
    q = _rand((B, S, H, D), 3)
    k, v = _rand((B, S, 1, D), 4), _rand((B, S, 1, D), 5)
    w = _rand((B, S, H, D), 6)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = np.asarray(_jax_naive(jq, jk, jv, causal))
    jg = jax.grad(lambda a, b, c: jnp.sum(_jax_naive(a, b, c, causal) * w),
                  argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = _t(q, grad=True), _t(k, grad=True), _t(v, grad=True)
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=FWD_TOL,
                               rtol=FWD_TOL)
    (out * _t(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_gqa_repeats_kv_heads_like_jnp_repeat():
    """Head h of q attends kv head h // (H / Hkv) (``jnp.repeat`` on axis
    2, i.e. ``repeat_interleave``), not h % Hkv (``Tensor.repeat``)."""
    B, S, H, Hkv, D = 1, 8, 4, 2, 16
    q = _rand((B, S, H, D), 7)
    k, v = _rand((B, S, Hkv, D), 8), _rand((B, S, Hkv, D), 9)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
    for h in range(H):
        one = tfa.flash_attention(_t(q[:, :, h:h + 1]),
                                  _t(k[:, :, h // 2:h // 2 + 1]),
                                  _t(v[:, :, h // 2:h // 2 + 1]),
                                  causal=True).numpy()
        np.testing.assert_allclose(got[:, :, h:h + 1], one, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_is_the_row_logsumexp(causal):
    B, S, H, D = 2, 50, 2, 16
    q, k, v = (_rand((B, S, H, D), s) for s in (10, 11, 12))
    _, lse = tfa.flash_attention_fwd_ref(_t(q), _t(k), _t(v), causal)
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(D)
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == (B * H, S)
    np.testing.assert_allclose(lse.numpy(), want.reshape(B * H, S),
                               atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [64, 45])
def test_backward_formulas_match_jax_grad(causal, S):
    B, H, D = 2, 3, 16
    q, k, v, w = (_rand((B, S, H, D), s) for s in (20, 21, 22, 23))
    jg = jax.grad(lambda a, b, c: jnp.sum(_jax_naive(a, b, c, causal) * w),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, grad=True), _t(k, grad=True), _t(v, grad=True)
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert out.grad_fn.name().startswith("FlashAttentionFunction")
    (out * _t(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
    # the plain pieces compose to the same gradients
    o, lse = tfa.flash_attention_fwd_ref(_t(q), _t(k), _t(v), causal)
    dq, dk, dv = tfa.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, lse,
                                             _t(w), causal)
    for a, b in zip((dq, dk, dv), (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _emulate_kernel(q, k, v, dout, lse_ref, causal, scale, extra=0,
                    tile=64):
    """The bf16 kernels' rounding, on the CPU in f64: the forward's online
    softmax over 64-column tiles (P rounded to bf16 against the running max,
    l summed unrounded), the backward's p and ds rounded to bf16 where the
    kernels round them, f64 sums, one rounding of each output. ``extra``
    widens the causal mask by that many columns (a planted fault)."""
    bf = torch.bfloat16
    B, S, H, D = q.shape
    qh, kh, vh, doh = (x.transpose(1, 2).double() for x in (q, k, v, dout))
    s = qh @ kh.mT * scale
    r = torch.arange(S)
    allowed = (r[None, :] <= r[:, None] + extra) if causal else \
        torch.ones((S, S), dtype=torch.bool)
    s = s.masked_fill(~allowed, -math.inf)
    pad = (-S) % tile
    sp = torch.nn.functional.pad(s, (0, pad), value=-math.inf)
    mt = sp.reshape(*s.shape[:-1], -1, tile).amax(-1).cummax(-1).values
    mt = mt.repeat_interleave(tile, -1)[..., :S]
    p = torch.exp(s - mt).nan_to_num()
    wgt = torch.exp(mt - mt[..., -1:]).nan_to_num()
    l = (p * wgt).sum(-1, keepdim=True)
    o = (p.to(bf).double() * wgt) @ vh / l
    out = o.transpose(1, 2).to(bf)
    lse = (mt[..., -1:] + torch.log(l))[..., 0].reshape(B * H, S).float()
    # backward on the saved lse of the sound forward
    delta = (doh * out.transpose(1, 2).double()).sum(-1, keepdim=True)
    pb = torch.exp(s - lse_ref.double().reshape(B, H, S, 1))
    ds = pb * (doh @ vh.mT - delta) * scale
    dq = ds.to(bf).double() @ kh
    dk = ds.to(bf).double().mT @ qh
    dv = pb.to(bf).double().mT @ doh
    return dict(out=out, lse=lse, **{n: x.transpose(1, 2).to(bf) for n, x in
                                     (("dq", dq), ("dk", dk), ("dv", dv))})


@pytest.mark.parametrize("causal,S", [(True, 100), (True, 64), (False, 80)])
def test_kernel_tolerance_covers_bf16_rounding_and_flags_a_wide_mask(causal,
                                                                    S):
    B, H, D = 2, 2, 64
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = (_t(_rand((B, S, H, D), s), torch.bfloat16)
                   for s in (40, 41, 42, 43))
    out, lse = tfa.flash_attention_fwd_ref(q, k, v, causal, scale)
    ref = dict(out=out, lse=lse)
    ref.update(zip(("dq", "dk", "dv"),
                   tfa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                               scale)))
    lim = tfa.kernel_tolerance(q, k, v, ref, causal, scale, dout=do)
    assert set(lim) == {"out", "lse", "dq", "dk", "dv"}
    for name in ("out", "dq", "dk", "dv"):
        assert float(lim[name].median()) < 0.1 * float(
            ref[name].float().abs().median()), name
    got = _emulate_kernel(q, k, v, do, lse, causal, scale)
    for name, x in got.items():
        err = (x.float() - ref[name].float()).abs()
        assert bool((err <= lim[name]).all()), (
            name, float((err / lim[name]).max()))
    if causal:
        wide = _emulate_kernel(q, k, v, do, lse, causal, scale, extra=1)
        for name in ("out", "dq", "dk", "dv"):
            err = (wide[name].float() - ref[name].float()).abs()
            assert bool((err > lim[name]).any()), name


def test_kernel_tolerance_f32_covers_another_summation_order():
    B, S, H, D = 1, 90, 2, 64
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = (_t(_rand((B, S, H, D), s)) for s in (50, 51, 52, 53))
    out, lse = tfa.flash_attention_fwd_ref(q, k, v, True, scale)
    ref = dict(out=out, lse=lse)
    ref.update(zip(("dq", "dk", "dv"), tfa.flash_attention_bwd_ref(
        q, k, v, out, lse, do, True, scale)))
    lim = tfa.kernel_tolerance(q, k, v, ref, True, scale, dout=do)
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    o64, lse64 = tfa.flash_attention_fwd_ref(qd, kd, vd, True, scale)
    g64 = tfa.flash_attention_bwd_ref(qd, kd, vd, o64, lse.double(), dod,
                                      True, scale)
    for name, x in zip(("out", "lse", "dq", "dk", "dv"), (o64, lse64) + g64):
        err = (x - ref[name].double()).abs()
        assert bool((err <= lim[name]).all()), name
    lse_fault = tfa.flash_attention_bwd_ref(q, k, v, out, lse + 0.5, do,
                                            True, scale)
    err = (lse_fault[2] - ref["dv"]).abs()
    assert bool((err > lim["dv"]).any())


def test_wrappers_run_plain_versions_on_cpu_tensors():
    q, k, v, do = (_t(_rand((1, 20, 2, 64), s)) for s in (60, 61, 62, 63))
    counts = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    out, lse = tfa.flash_fwd(q, k, v, True)
    delta = tfa.attention_delta(out, do)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == counts
    ro, rl = tfa.flash_attention_fwd_ref(q, k, v, True)
    torch.testing.assert_close(out, ro, atol=0, rtol=0)
    torch.testing.assert_close(lse, rl, atol=0, rtol=0)
    for a, b in zip((dq, dk, dv),
                    tfa.flash_attention_bwd_ref(q, k, v, out, lse, do, True)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_kernel_wrappers_refuse_what_the_kernels_cannot_run():
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_fwd(q, q, q)
    ok = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="head_dim"):
        tfa._kernel_inputs("t", torch.zeros((1, 8, 2, 32)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._kernel_inputs("t", ok.half())
    with pytest.raises(TypeError, match="dtypes differ"):
        tfa._kernel_inputs("t", ok, ok.bfloat16())
    with pytest.raises(ValueError, match="repeat GQA"):
        tfa._kernel_inputs("t", ok, torch.zeros((1, 8, 1, 64)))
    with pytest.raises(ValueError, match="unsupported shapes"):
        tfa.flash_attention(ok, torch.zeros((1, 9, 2, 64)),
                            torch.zeros((1, 9, 2, 64)))


def test_supports_matches_the_self_attention_contract():
    assert tfa.supports((2, 128, 8, 64), (2, 128, 2, 64))
    assert tfa.supports((2, 37, 8, 16), (2, 37, 8, 16))
    assert not tfa.supports((2, 128, 8, 64), (2, 64, 8, 64))    # cross
    assert not tfa.supports((2, 128, 8, 64), (2, 128, 3, 64))   # 8 % 3
    assert not tfa.supports((2, 128, 8, 64), (1, 128, 8, 64))   # batch


def test_dropout_and_unported_forms_raise():
    q = _t(_rand((1, 16, 2, 16), 70))
    with pytest.raises(NotImplementedError, match="dropout"):
        TF.flash_attention(q, q, q, dropout=0.1, causal=True)
    with pytest.raises(NotImplementedError, match="dropout"):
        TF.scaled_dot_product_attention(q, q, q, dropout_p=0.1)
    out, _ = TF.flash_attention(q, q, q, dropout=0.1, causal=True,
                                training=False)
    assert torch.isfinite(out).all()
    for fn in (TF.flashmask_attention, TF.flash_attn_unpadded):
        with pytest.raises(NotImplementedError, match="B6"):
            fn(q, q, q)


def test_backend_marker_names_the_path():
    q = _t(_rand((1, 16, 2, 16), 80))
    TF.flash_attention(q, q, q, causal=True)
    assert TF.get_last_attention_backend() == "plain"
    # cross-attention shapes go to _sdpa_core on the CPU, also "plain"
    kv = _t(_rand((1, 9, 2, 16), 81))
    out, _ = TF.flash_attention(q, kv, kv)
    assert out.shape == q.shape
    assert TF.get_last_attention_backend() == "plain"


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_core_matches_jax(causal):
    B, S, H, D = 2, 12, 4, 8
    q = _rand((B, S, H, D), 90)
    k, v = _rand((B, S, 2, D), 91), _rand((B, S, 2, D), 92)
    mask = np.random.default_rng(93).random((B, 1, S, S)) > 0.3
    mask[..., 0] = True
    ref = np.asarray(_sdpa_core(*map(jnp.asarray, (q, k, v, mask)),
                                1 / math.sqrt(D), causal, 0.0, False))
    got = TF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                          torch.from_numpy(mask),
                                          is_causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, atol=FWD_TOL, rtol=FWD_TOL)
