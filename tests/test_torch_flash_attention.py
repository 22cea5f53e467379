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

The forward of ``test_forward_matches_jax_sdpa`` is held to a per-element
bound derived from f32 rounding over its row (``_f32_forward_bound``, up to
7e-5 on these rows), not to the fixed 2e-5, which lies below that worst
case for some elements and once read 3.1e-5 against it. A causal mask one
short still fails the bound by orders of magnitude
(``test_f32_forward_bound_fails_a_mask_one_short``).
"""
import importlib
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


def _gamma(n, u=2.0 ** -24):
    """gamma_n = n u / (1 - n u): the relative bound of n f32 roundings."""
    return n * u / (1 - n * u)


def _f32_forward_bound(q, k, v, causal):
    """Per output element [B, S, H, D]: the first-order worst case of f32
    rounding in two evaluations of softmax(q k^T / sqrt(D)) v that may
    order their sums differently. Per (row, column): the score's error is
    at most gamma_{D+1} sum_i |q_i k_i| scale; a probability's relative
    error at most twice the row's largest score error (its own score and
    the normaliser's), plus exp's rounding over the score range and
    gamma_{T+1} for the sum and the division; the output's at most
    sum_j p_j |v_j| (that relative error + gamma_T). Two sides: doubled."""
    u = 2.0 ** -24
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qa, ka, va = (np.abs(x).astype(np.float64) for x in (q, k, v))
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    mag = np.einsum("bshd,bthd->bhst", qa, ka) * scale
    T = s.shape[-1]
    allowed = (np.tril(np.ones((s.shape[-2], T), bool)) if causal
               else np.ones((s.shape[-2], T), bool))
    s = np.where(allowed, s, -np.inf)
    err_s = np.where(allowed, _gamma(D + 1) * mag, 0.0)
    span = np.where(allowed, s.max(-1, keepdims=True) - s, 0.0)
    rel_p = (2 * err_s.max(-1, keepdims=True)
             + u * (1 + span.max(-1, keepdims=True)) + _gamma(T + 1))
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    weight = np.einsum("bhst,bthd->bshd", p, va)
    rel = np.transpose(rel_p, (0, 2, 1, 3)) + _gamma(T)       # [B, S, H, 1]
    return 2 * weight * rel


def _assert_within(got, ref, bound):
    err = np.abs(np.asarray(got, np.float64) - ref)
    worst = float((err / bound).max())
    assert worst <= 1.0, f"max |got - ref| / bound = {worst}"


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [64, 37])
def test_forward_matches_jax_sdpa(causal, S):
    B, H, D = 2, 3, 16
    q, k, v = (_rand((B, S, H, D), s) for s in (0, 1, 2))
    ref = np.asarray(_jax_naive(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal))
    bound = _f32_forward_bound(q, k, v, causal)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    _assert_within(got.numpy(), ref, bound)
    out, _ = TF.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    _assert_within(out.numpy(), ref, bound)


def test_f32_forward_bound_fails_a_mask_one_short():
    """The planted fault: each query row misses its own key (causal mask
    one short). Every row but the first moves far past the bound."""
    B, S, H, D = 2, 64, 3, 16
    q, k, v = (_rand((B, S, H, D), s) for s in (0, 1, 2))
    ref = np.asarray(_jax_naive(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), True))
    bound = _f32_forward_bound(q, k, v, True)
    short = np.tril(np.ones((S, S), bool), -1)
    short[0, 0] = True                          # row 0 keeps its one key
    bad = TF.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), attn_mask=torch.from_numpy(short)).numpy()
    err = np.abs(bad.astype(np.float64) - ref)
    assert float((err / bound).max()) > 100.0
    with pytest.raises(AssertionError, match="bound"):
        _assert_within(bad, ref, bound)
    # the bound is not slack where the sides agree: well under 1e-4
    assert float(bound.max()) < 1e-4


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
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tfa._kernel_inputs("t", ok.double())
    assert tfa._kernel_inputs("t", ok.half())[0].dtype == torch.float16
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
    """Attention dropout in training takes the plain route (JAX's XLA
    route); packed varlen attention still raises on it (ROADMAP C)."""
    q = _t(_rand((1, 16, 2, 16), 70))
    out, _ = TF.flash_attention(q, q, q, dropout=0.1, causal=True)
    assert TF.get_last_attention_backend() == "plain"
    assert torch.isfinite(out).all()
    assert torch.isfinite(TF.scaled_dot_product_attention(
        q, q, q, dropout_p=0.1)).all()
    out, _ = TF.flash_attention(q, q, q, dropout=0.1, causal=True,
                                training=False)
    assert torch.isfinite(out).all()
    sri = torch.full((1, 1, 16, 1), 16)
    cu = torch.tensor([0, 9, 16])
    assert TF.flashmask_attention(q, q, q, sri, causal=True).shape == q.shape
    assert TF.flash_attn_unpadded(q[0], q[0], q[0], cu, cu, 9, 9, 0.25,
                                  causal=True)[0].shape == q[0].shape
    assert TF.flashmask_attention(q, q, q, sri,
                                  dropout=0.1).shape == q.shape
    assert TF.get_last_attention_backend() == "plain"
    with pytest.raises(NotImplementedError, match="dropout"):
        TF.flash_attn_unpadded(q[0], q[0], q[0], cu, cu, 9, 9, 0.25,
                               dropout=0.1)


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


_CROSS = {"longer_k": ((2, 16, 4, 16), (2, 24, 2, 16)),
          "shorter_k": ((2, 20, 4, 16), (2, 12, 4, 16)),
          "batch_1_k": ((2, 16, 4, 16), (1, 16, 4, 16))}


@pytest.mark.parametrize("form", ["flash", "flashmask"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shapes", list(_CROSS), ids=list(_CROSS))
def test_cross_shapes_take_the_plain_route_with_jax_values(form, causal,
                                                           shapes):
    """q and k of different lengths or batches: JAX's dispatcher takes its
    XLA route (its Pallas kernel refuses them); the port takes the plain
    route, reported "plain", with JAX's values within FWD_TOL (f32 sums in
    another order)."""
    import paddle_tpu as P
    import paddle_tpu.nn.functional as JF
    # the package's name ``flash_attention`` is the function: the module
    jfa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
    qs, ks = _CROSS[shapes]
    q, k, v = _rand(qs, 100), _rand(ks, 101), _rand(ks, 102)
    T, n = ks[1], (1 if causal else 2)
    rng = np.random.default_rng(103)
    sri = np.sort(rng.integers(0, qs[1] + 1, (ks[0], 1, T, n)), -1)
    if form == "flash":
        want = np.asarray(JF.flash_attention(
            *map(P.to_tensor, (q, k, v)), causal=causal)[0]._value)
        got, _ = TF.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    else:
        want = np.asarray(JF.flashmask_attention(
            *map(P.to_tensor, (q, k, v)), P.to_tensor(sri),
            causal=causal)._value)
        got = TF.flashmask_attention(_t(q), _t(k), _t(v),
                                     torch.from_numpy(sri), causal=causal)
    assert jfa.get_last_attention_backend() == "xla"
    assert TF.get_last_attention_backend() == "plain"
    assert got.shape == want.shape
    # rows JAX fills with the mean of V where every column is hidden
    # (flashmask) agree too: both routes run the same masked softmax
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


# ------------------------------------- head dims no kernel takes (16, 32, 96)
@pytest.mark.parametrize("D", [16, 32, 96])
@pytest.mark.parametrize("causal", [False, True])
def test_other_head_dims_match_jax(D, causal):
    """Head dims the kernels do not take: JAX computes them on its XLA
    route; the port's three functionals give its values (the kernels'
    plain versions on the CPU; on CUDA the plain route,
    ``tests/test_torch_cuda_script.py``)."""
    import paddle_tpu as P
    import paddle_tpu.nn.functional as JF

    B, S, H = 2, 40, 4
    q, k, v = (_rand((B, S, H, D), 110 + i) for i in range(3))
    want = np.asarray(JF.flash_attention(*map(P.to_tensor, (q, k, v)),
                                         causal=causal)[0]._value)
    got, _ = TF.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
    sri = np.sort(np.random.default_rng(D).integers(
        S // 2, S + 1, (B, 1, S, 1 if causal else 2)), -1)
    if not causal:
        sri[..., 0] = S       # lower band [S, hi): empty, rows keep columns
    want = np.asarray(JF.flashmask_attention(
        *map(P.to_tensor, (q, k, v)), P.to_tensor(sri),
        causal=causal)._value)
    got = TF.flashmask_attention(_t(q), _t(k), _t(v), torch.from_numpy(sri),
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
    cu = np.array([0, 30, 80], dtype=np.int32)
    packed = [x.reshape(B * S, H, D) for x in (q, k, v)]
    scale = 1.0 / math.sqrt(D)
    want = np.asarray(JF.flash_attn_unpadded(
        *map(P.to_tensor, packed), P.to_tensor(cu), P.to_tensor(cu), 50, 50,
        scale, causal=causal)[0]._value)
    got, _ = TF.flash_attn_unpadded(*map(_t, packed), torch.from_numpy(cu),
                                    torch.from_numpy(cu), 50, 50, scale,
                                    causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("D", [16, 32, 96])
def test_decode_entry_points_at_other_head_dims_match_jax(D):
    """``decode_attention`` and ``paged_decode_attention`` at head dims no
    kernel takes: the port's entry points (their plain versions here; the
    models pick the plain versions on CUDA, ``models.steps.kernel_serves``)
    against JAX's plain route (``kernel="xla"``)."""
    from paddle_tpu.ops.pallas import decode_attention as jda
    from paddle_tpu_torch.ops import decode_attention as tda
    from paddle_tpu_torch.ops import paged_attention as tpa

    B, S, Hq, Hkv, T = 2, 3, 4, 2, 48
    q = _rand((B, S, Hq, D), 120)
    kc, vc = _rand((B, Hkv, T, D), 121), _rand((B, Hkv, T, D), 122)
    lengths = np.array([20, 41], dtype=np.int32)
    want = np.asarray(jda.decode_attention_xla(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths)))
    got = tda.decode_attention(_t(q), _t(kc), _t(vc),
                               torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
    BS, NB = 16, T // 16
    tables = np.arange(B * NB, dtype=np.int32).reshape(B, NB)
    pages = [x.transpose(1, 0, 2, 3).reshape(Hkv, B * NB, BS, D)
             for x in (kc, vc)]
    got = tpa.paged_decode_attention(_t(q), *map(_t, pages),
                                     torch.from_numpy(tables),
                                     torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


_TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
             max_position=128)


@pytest.fixture(scope="module")
def jax_tiny_forward():
    """``gpt_tiny()``'s weights and JAX's cache-free logits on seeded ids
    (computed once: JAX's eager forward compiles op by op)."""
    import paddle_tpu as P
    from paddle_tpu.models import gpt as jgpt

    with P.utils.unique_name.guard():
        P.seed(3)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**_TINY))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    ids = np.random.default_rng(3).integers(0, 1024, (2, 20))
    return state, ids, np.asarray(jm(P.to_tensor(ids))._value)


def test_gpt_tiny_forward_at_its_head_dim_matches_jax(jax_tiny_forward):
    """``gpt_tiny()`` (head dim 16) on the same weights: the cache-free
    forward's logits within 1e-5 of JAX's."""
    from paddle_tpu_torch import from_paddle_tpu_state
    from paddle_tpu_torch.models import gpt as tgpt

    state, ids, want = jax_tiny_forward
    tm = from_paddle_tpu_state(state, tgpt.GPTConfig(**_TINY),
                               device="cpu").eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert tm.config.hidden_size // tm.config.num_heads == 16
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
