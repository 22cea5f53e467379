"""FlashMask attention of the PyTorch port held against the JAX package on
the same numpy inputs.

The JAX Pallas FlashMask path cannot serve as the CPU reference under this
jax (``_no_x64`` imports ``jax.experimental.enable_x64``), so the port is
held against JAX's public ``F.flashmask_attention`` (its XLA route on CPU)
for the forward, and against ``jax.grad`` of ``_sdpa_core`` under the mask
``_allowed_mask`` builds (plain ``jnp``, no ``pallas_call``) for the
gradients. Tolerances are those of ``tests/test_pallas_flash_attention.py``:
2e-5 on the forward (f32 sums in another order), 5e-5 on the gradients.

A row with no allowed column gives 0 in the port, as in the Pallas kernel
(``tests/test_advice_regressions.py::test_flashmask_fully_masked_rows_zero``);
JAX's XLA route fills masked scores with ``finfo.min`` and gives the mean of
V there. So the port is held to JAX on the rows with an allowed column, and
its fully masked rows and their gradients are pinned to exactly 0 on their
own (the gradient legs weight those rows by 0, where JAX's gradients are 0
too).

On CPU tensors the wrappers run the kernels' plain versions; the masked
kernels are held to the same plain versions on the card in
``test_torch_cuda_kernels.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.functional.flash_attention import _sdpa_core
from paddle_tpu.ops.pallas import flash_attention as pfa
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 2e-5
GRAD_TOL = 5e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x, dtype=torch.float32, grad=False):
    return torch.from_numpy(x).to(dtype).requires_grad_(grad)


def _jax_allowed(sri, causal):
    """[B, H', S, S] bool from ``_allowed_mask``, one (batch, head) at a
    time."""
    S = sri.shape[2]
    rows, cols = (jnp.asarray(a, jnp.int32) for a in
                  np.meshgrid(np.arange(S), np.arange(S), indexing="ij"))
    return np.stack([np.stack([np.asarray(pfa._allowed_mask(
        rows, cols, jnp.asarray(sri[b, h], jnp.int32), causal, S))
        for h in range(sri.shape[1])]) for b in range(sri.shape[0])])


def _sri(B, Hp, S, n, causal, seed):
    """A random FlashMask with rows of both kinds. Causal: starts at or
    after their column (document-like ends), and columns 0-2 hidden from
    row 0, so rows 0-2 see nothing. Non-causal: n = 1 hides the last four
    rows in every column; n >= 2 hides rows 0-2 ([0, LTE >= 3)), and n = 4
    adds an upper band in the second half."""
    rng = np.random.default_rng(seed)
    shape = (B, Hp, S)
    if causal:
        start = rng.integers(np.arange(S), S + 1, shape)
        start[..., :3] = 0
        parts = [start]
        if n == 2:
            end = start + rng.integers(1, S, shape)
            end[..., :3] = S
            parts.append(end)
    elif n == 1:
        parts = [rng.integers(S - 8, S - 3, shape)]
    else:
        parts = [np.zeros(shape, np.int64), rng.integers(3, S // 2, shape)]
        uts = rng.integers(S // 2, S, shape)
        parts += [uts, uts + rng.integers(1, S // 2, shape)][:n - 2]
    return np.stack(parts, -1).astype(np.int64)


@pytest.mark.parametrize("causal,n", [(True, 1), (True, 2), (False, 1),
                                      (False, 2), (False, 3), (False, 4)])
def test_flashmask_allowed_matches_allowed_mask(causal, n):
    S = 53
    sri = np.random.default_rng(n).integers(-2, S + 3, (2, 3, S, n))
    want = _jax_allowed(sri, causal)
    got = tfa.flashmask_allowed(S, torch.from_numpy(sri), causal).numpy()
    np.testing.assert_array_equal(got, want)


CASES = [  # (causal, n, H', kv heads, S)
    (True, 1, 1, 3, 64),
    (True, 2, 3, 3, 45),
    (False, 1, 3, 3, 64),
    (False, 2, 1, 1, 50),      # GQA: one kv head
    (False, 4, 1, 3, 70),
]


def _inputs(causal, n, Hp, Hkv, S, seed):
    B, H, D = 2, 3, 16
    q = _rand((B, S, H, D), seed)
    k, v = _rand((B, S, Hkv, D), seed + 1), _rand((B, S, Hkv, D), seed + 2)
    sri = _sri(B, Hp, S, n, causal, seed + 3)
    allowed = _jax_allowed(sri, causal)                   # [B, H', S, S]
    live = np.broadcast_to(allowed.any(-1), (B, H, S)).transpose(0, 2, 1)
    return q, k, v, sri, live[..., None]                  # live [B, S, H, 1]


@pytest.mark.parametrize("causal,n,Hp,Hkv,S", CASES)
def test_forward_matches_jax_flashmask_on_live_rows(causal, n, Hp, Hkv, S):
    q, k, v, sri, live = _inputs(causal, n, Hp, Hkv, S, seed=10 * n + S)
    assert live.all(-1).any() and not live.all()     # both kinds of rows
    ref = np.asarray(JF.flashmask_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)),
        startend_row_indices=paddle.to_tensor(sri), causal=causal)._value)
    got = TF.flashmask_attention(_t(q), _t(k), _t(v), torch.from_numpy(sri),
                                 causal=causal)
    assert TF.get_last_attention_backend() == "plain"
    assert got.shape == ref.shape and got.dtype == torch.float32
    live = np.broadcast_to(live, got.shape)
    np.testing.assert_allclose(got.numpy()[live], ref[live], atol=FWD_TOL,
                               rtol=FWD_TOL)
    assert (got.numpy()[~live] == 0).all()


@pytest.mark.parametrize("causal,n,Hp,Hkv,S", CASES)
def test_gradients_match_jax_grad_of_masked_sdpa(causal, n, Hp, Hkv, S):
    q, k, v, sri, live = _inputs(causal, n, Hp, Hkv, S, seed=7 * n + S)
    w = _rand(q.shape, 99) * live                    # dead rows weigh 0
    mask = jnp.asarray(_jax_allowed(sri, causal))
    scale = 1.0 / math.sqrt(q.shape[-1])
    jg = jax.grad(lambda a, b, c: jnp.sum(
        _sdpa_core(a, b, c, mask, scale, False, 0.0, False) * w),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, grad=True), _t(k, grad=True), _t(v, grad=True)
    out = tfa.flashmask_attention(tq, tk, tv, torch.from_numpy(sri), causal)
    assert out.grad_fn.name().startswith("FlashMaskFunction")
    (out * _t(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
    dead = np.broadcast_to(~live, q.shape)
    assert (tq.grad.numpy()[dead] == 0).all()


def test_fully_masked_rows_and_their_gradients_are_exactly_zero():
    """The twin of test_flashmask_fully_masked_rows_zero: causal, start 0 in
    every column hides every row; out, dq, dk and dv are exactly 0."""
    B, S, H, D = 1, 70, 2, 16
    q, k, v = (_t(_rand((B, S, H, D), s), grad=True) for s in (1, 2, 3))
    sri = torch.zeros((B, 1, S, 1), dtype=torch.int64)
    out = tfa.flashmask_attention(q, k, v, sri, causal=True)
    assert torch.equal(out, torch.zeros_like(out))
    (out ** 2).sum().backward()
    for g in (q.grad, k.grad, v.grad):
        assert torch.equal(g, torch.zeros_like(g))
    _, lse = tfa.flash_attention_fwd_ref(q, k, v, True,
                                         sri=sri.to(torch.int32))
    assert torch.equal(lse, torch.zeros_like(lse))


def test_one_mask_head_is_broadcast_like_a_mask_per_head():
    B, S, H, D = 2, 33, 4, 16
    q, k, v = (_t(_rand((B, S, H, D), s)) for s in (4, 5, 6))
    sri = torch.from_numpy(_sri(B, 1, S, 2, True, 7))
    one = tfa.flashmask_attention(q, k, v, sri, causal=True)
    every = tfa.flashmask_attention(q, k, v, sri.expand(B, H, S, 2),
                                    causal=True)
    assert torch.equal(one, every)


def test_a_mask_that_hides_nothing_is_plain_causal_attention():
    B, S, H, D = 1, 40, 2, 16
    q, k, v = (_t(_rand((B, S, H, D), s)) for s in (8, 9, 10))
    sri = torch.full((B, 1, S, 1), S)
    torch.testing.assert_close(tfa.flashmask_attention(q, k, v, sri, True),
                               tfa.flash_attention(q, k, v, True),
                               atol=0, rtol=0)


def test_without_a_mask_it_is_flash_attention_and_extras_are_none():
    q = _t(_rand((1, 20, 2, 16), 11))
    out = TF.flashmask_attention(q, q, q, causal=True)
    torch.testing.assert_close(out, TF.flash_attention(q, q, q,
                                                       causal=True)[0])
    out, lse, seed = TF.flashmask_attention(q, q, q, causal=True,
                                            return_softmax_lse=True,
                                            return_seed_offset=True)
    assert out.shape == q.shape and lse is None and seed is None


def test_window_size_dropout_and_bad_masks_raise():
    q = _t(_rand((1, 16, 2, 16), 12))
    sri = torch.full((1, 1, 16, 1), 16)
    with pytest.raises(NotImplementedError, match="window_size"):
        TF.flashmask_attention(q, q, q, sri, window_size=(4, 4))
    # dropout in training: the plain route's masked softmax, as in JAX
    assert TF.flashmask_attention(q, q, q, sri, dropout=0.1).shape == q.shape
    assert TF.get_last_attention_backend() == "plain"
    with pytest.raises(ValueError, match="1 or H"):
        tfa.flashmask_attention(q, q, q, sri.expand(1, 3, 16, 1).clone())
    with pytest.raises(ValueError, match="n <= 4"):
        tfa.flashmask_attention(q, q, q, torch.zeros((1, 1, 16, 5)))
    with pytest.raises(TypeError, match="int32"):
        tfa.flash_fwd(q, q, q, True, sri=sri)            # int64 at the kernel
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd(q, q, q, True,
                      sri=torch.zeros((1, 1, 2, 16), dtype=torch.int32).mT)


def _emulate_masked_kernel(q, k, v, dout, lse_ref, allowed, scale, tile=64):
    """The bf16 masked kernels' rounding, on the CPU in f64: the forward's
    online softmax over 64-column tiles (P rounded to bf16 against the
    running max; a tile with no allowed entry adds nothing, as the skip
    does), 0 for rows with no allowed column, the backward's p and ds
    rounded where the kernels round them, f64 sums, one rounding of each
    output. ``allowed``: [B, H', S, S]."""
    bf = torch.bfloat16
    B, S, H, D = q.shape
    qh, kh, vh, doh = (x.transpose(1, 2).double() for x in (q, k, v, dout))
    s = (qh @ kh.mT * scale).masked_fill(~allowed, -math.inf)
    sp = torch.nn.functional.pad(s, (0, (-S) % tile), value=-math.inf)
    mt = sp.reshape(*s.shape[:-1], -1, tile).amax(-1).cummax(-1).values
    mt = mt.repeat_interleave(tile, -1)[..., :S]
    p = torch.exp(s - mt).nan_to_num()
    wgt = torch.exp(mt - mt[..., -1:]).nan_to_num()
    l = (p * wgt).sum(-1, keepdim=True)
    live = l > 0
    o = torch.where(live, (p.to(bf).double() * wgt) @ vh / l, 0.0)
    out = o.transpose(1, 2).to(bf)
    lse = torch.where(live, mt[..., -1:] + torch.log(l), 0.0)
    lse = lse[..., 0].reshape(B * H, S).float()
    delta = (doh * out.transpose(1, 2).double()).sum(-1, keepdim=True)
    pb = torch.exp(s - lse_ref.double().reshape(B, H, S, 1))
    ds = pb * (doh @ vh.mT - delta) * scale
    grads = (ds.to(bf).double() @ kh, ds.to(bf).double().mT @ qh,
             pb.to(bf).double().mT @ doh)
    return dict(out=out, lse=lse, **{n: x.transpose(1, 2).to(bf) for n, x in
                                     zip(("dq", "dk", "dv"), grads)})


@pytest.mark.parametrize("causal,n,S", [(True, 1, 150), (False, 4, 100)])
def test_kernel_tolerance_covers_masked_bf16_and_flags_a_short_mask(causal,
                                                                   n, S):
    """Documents of 40 and 37 rows and the rest: causal [end], or
    non-causal [end, S, 0, start]; the planted fault is every document's
    end one short."""
    B, H, D = 1, 2, 64
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = (_t(_rand((B, S, H, D), s), torch.bfloat16)
                   for s in (40, 41, 42, 43))
    cu = torch.tensor([0, 40, 77, S])
    seg = torch.searchsorted(cu[1:-1], torch.arange(S), right=True)
    end, start = cu[seg + 1], cu[seg]
    cols = [end] if causal else [end, torch.full_like(end, S),
                                 torch.zeros_like(end), start]
    sri = torch.stack(cols, -1)[None, None].to(torch.int32)
    out, lse = tfa.flash_attention_fwd_ref(q, k, v, causal, scale, sri)
    ref = dict(out=out, lse=lse)
    ref.update(zip(("dq", "dk", "dv"), tfa.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal, scale, sri)))
    lim = tfa.kernel_tolerance(q, k, v, ref, causal, scale, dout=do, sri=sri)
    for name in ("out", "dq", "dk", "dv"):
        assert float(lim[name].median()) < 0.1 * float(
            ref[name].float().abs().median()), name
    allowed = tfa.flashmask_allowed(S, sri, causal)
    got = _emulate_masked_kernel(q, k, v, do, lse, allowed, scale)
    for name, x in got.items():
        err = (x.float() - ref[name].float()).abs()
        assert bool((err <= lim[name]).all()), (
            name, float((err / lim[name]).max()))
    short = sri.clone()
    short[..., 0] -= 1
    bad = _emulate_masked_kernel(q, k, v, do, lse,
                                 tfa.flashmask_allowed(S, short, causal),
                                 scale)
    for name in ("out", "dq", "dk", "dv"):
        err = (bad[name].float() - ref[name].float()).abs()
        assert bool((err > lim[name]).any()), name


def test_masked_wrappers_run_plain_versions_and_count_apart():
    B, S, H, D = 1, 30, 2, 64
    q, k, v, do = (_t(_rand((B, S, H, D), s)) for s in (60, 61, 62, 63))
    sri = torch.from_numpy(_sri(B, 1, S, 1, True, 64)).to(torch.int32)
    names = ("fwd", "dq", "dkv", "fm_fwd", "fm_dq", "fm_dkv")
    counts = [tfa._WRAPPERS[n].launches for n in names]
    out, lse = tfa.flashmask_fwd(q, k, v, sri, True)
    delta = tfa.attention_delta(out, do)
    dq = tfa.flashmask_bwd_dq(q, k, v, do, lse, delta, sri, True)
    dk, dv = tfa.flashmask_bwd_dkv(q, k, v, do, lse, delta, sri, True)
    assert [tfa._WRAPPERS[n].launches for n in names] == counts   # CPU
    ro, rl = tfa.flash_attention_fwd_ref(q, k, v, True, sri=sri)
    torch.testing.assert_close(out, ro, atol=0, rtol=0)
    torch.testing.assert_close(lse, rl, atol=0, rtol=0)
    for a, b in zip((dq, dk, dv), tfa.flash_attention_bwd_ref(
            q, k, v, out, lse, do, True, sri=sri)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
