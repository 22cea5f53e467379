"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a GPU.

This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances are each module's ``kernel_tolerance``, elementwise. Paged and
dense split-KV attention: f32 1e-4 (another summation order over up to ~1k
columns); bf16 2^-7 (|ref| + sum_j p_j |v_j|) (unnormalised probabilities
and the output rounded to bf16 at other places than the plain version's);
f16 2^-10 of the same, plus 2^-24 (1 + sum_j |v_j|).
Flash attention:
2^-7 (|ref| + the magnitude of the sum) for bf16, 2^-10 of the same for
f16 (plus 2^-24 per rounded term: f16's subnormal spacing), plus 2^-16 of
the f32 sums' magnitude for another summation order
(``flash_attention.kernel_tolerance`` states each term). The f16 forms of
the flash kernels are the bf16 ones with f16 products, and so are those
of the paged and dense kernels. Every kernel family takes B * H (or
B * Hkv) past grid.y's 65535 by folding the excess into another grid axis;
one case each runs just past it.
"""
import gc

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(device, B, S, Hkv, G, D, BS, lengths, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    NB = -(-(max(lengths) + S) // BS)
    P = B * NB + 3
    td = getattr(torch, dtype)
    q = torch.randn((B, S, Hkv * G, D), generator=g, device=device).to(td)
    kp = torch.randn((Hkv, P, BS, D), generator=g, device=device).to(td)
    vp = torch.randn((Hkv, P, BS, D), generator=g, device=device).to(td)
    perm = np.random.default_rng(seed).permutation(P)
    tables = np.zeros((B, NB), np.int32)     # past the extent: page 0
    for b, ln in enumerate(lengths):
        n = -(-(ln + S) // BS)
        tables[b, :n] = perm[b * NB:b * NB + n]
    return (q, kp, vp, torch.as_tensor(tables, device=device),
            torch.as_tensor(np.asarray(lengths, np.int32), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("G,S,BS,D", [(1, 1, 32, 64), (4, 1, 16, 64),
                                      (1, 64, 32, 64), (4, 5, 64, 128),
                                      (8, 3, 128, 64), (1, 128, 32, 128),
                                      # prefill width at every block size:
                                      # a 64-column tile spans 4, 2, 1 or
                                      # half a page
                                      (1, 64, 16, 64), (4, 64, 16, 64),
                                      (4, 64, 32, 64), (1, 64, 64, 64),
                                      (4, 64, 64, 64), (1, 64, 128, 64),
                                      (4, 64, 128, 64)])
def test_paged_attention_kernel_matches_plain(cuda, dtype, G, S, BS, D):
    """Lengths 0, 37, 300 and 129: an empty slot, and live prefixes that
    end inside a tile and inside a page at every block size."""
    args = _case(cuda, 4, S, 2, G, D, BS, [0, 37, 300, 129], dtype)
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention.launches == before + 1
    ref = tpa.paged_decode_attention_ref(*args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    assert bool((err <= tpa.kernel_tolerance(*args, ref)).all()), (
        f"max |kernel - plain| {float(err.max())}")


@pytest.mark.cuda
def test_paged_attention_kernel_rejects_what_it_cannot_run(cuda):
    q, kp, vp, tbl, ln = _case(cuda, 2, 1, 2, 1, 64, 32, [5, 9], "float32")
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_decode_attention(q[..., :32].contiguous(),
                                   kp[..., :32].contiguous(),
                                   vp[..., :32].contiguous(), tbl, ln)
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_decode_attention(q, kp, vp, tbl.long(), ln)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tpa.paged_decode_attention(q.double(), kp.double(), vp.double(),
                                   tbl, ln)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_decode_attention(q, kp.transpose(2, 3).contiguous()
                                   .transpose(2, 3), vp, tbl, ln)


@pytest.mark.cuda
def test_step_programs_on_the_card_match_the_plain_path(cuda):
    """A small GPT (head dim 64, as the kernel needs) gives the same greedy
    tokens through the kernel as through the plain attention path (f32)."""
    from paddle_tpu_torch.inference import PagedKVCache
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    m = GPTForCausalLM(GPTConfig(vocab_size=1024, hidden_size=128,
                                 num_layers=2, num_heads=2, max_position=128),
                       device=cuda, seed=1)
    prompt = np.arange(11) * 7 % 1024
    outs = []
    for path in ("kernel", "plain"):
        kv = PagedKVCache(*m._decode_cache_spec(), block_size=16,
                          num_blocks=4, dtype=torch.float32, device=cuda)
        tbl = kv.reserve("a", 20)[None]
        tok = m.prefill_chunk(prompt[None], [0], [11], kv, tbl,
                              decode_kernel=path)
        toks = m.decode_step(tok, [11], [True], kv, tbl, steps=5,
                             max_lens=[20], decode_kernel=path)
        outs.append(np.concatenate([tok, toks[0]]))
    np.testing.assert_array_equal(outs[0], outs[1])


def _flash_case(device, B, S, H, D, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((B, S, H, D), generator=g, device=device).to(
        getattr(torch, dtype)) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal,S,D", [(True, 256, 64), (False, 100, 64),
                                        (True, 77, 128), (False, 1, 128),
                                        (True, 1000, 64), (False, 1000, 64),
                                        (True, 1000, 128), (False, 1000, 128),
                                        (True, 1025, 64), (False, 1025, 64),
                                        (True, 1025, 128),
                                        (False, 1025, 128),
                                        # the rings' edges: one row, a tile
                                        # one short, one full, one row past,
                                        # a tile and a row past two
                                        (True, 1, 64), (False, 1, 64),
                                        (True, 63, 64), (False, 63, 64),
                                        (True, 64, 64), (False, 64, 64),
                                        (True, 65, 64), (False, 65, 64),
                                        (True, 129, 64), (False, 129, 64)])
def test_flash_kernels_match_plain(cuda, dtype, causal, S, D):
    q, k, v, do = _flash_case(cuda, 2, S, 3, D, dtype, seed=S)
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    out, lse = tfa.flash_fwd(q, k, v, causal)
    ro, rl = tfa.flash_attention_fwd_ref(q, k, v, causal)
    delta = tfa.attention_delta(ro, do)
    got = dict(out=out, lse=lse,
               dq=tfa.flash_bwd_dq(q, k, v, do, rl, delta, causal))
    got["dk"], got["dv"] = tfa.flash_bwd_dkv(q, k, v, do, rl, delta, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    ref = dict(out=ro, lse=rl,
               dq=tfa.flash_attention_dq_ref(q, k, v, do, rl, delta, causal))
    ref["dk"], ref["dv"] = tfa.flash_attention_dkv_ref(q, k, v, do, rl,
                                                       delta, causal)
    lim = tfa.kernel_tolerance(q, k, v, ref, causal, dout=do)
    for name, x in got.items():
        assert x.dtype == ref[name].dtype and x.shape == ref[name].shape
        err = (x.float() - ref[name].float()).abs()
        assert bool((err <= lim[name]).all()), (
            f"{name}: max |kernel - plain| {float(err.max())}, "
            f"{float((err / lim[name]).max())} of the limit")


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_cannot_run(cuda):
    q, k, v, _ = _flash_case(cuda, 1, 16, 2, 64, "float32")
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tfa.flash_fwd(q.double(), k.double(), v.double())
    sri = torch.full((1, 1, 16, 2), 16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flashmask_fwd(q, k, v, sri[..., ::2], True)
    from paddle_tpu_torch.nn import functional as F
    # attention dropout in training takes the plain route, as in JAX
    F.flash_attention(q, k, v, dropout=0.1)
    assert F.get_last_attention_backend() == "plain"
    # q and k of different lengths: the plain route, as JAX takes XLA
    out, _ = F.flash_attention(q, k[:, :8], v[:, :8])
    assert F.get_last_attention_backend() == "plain"
    assert out.shape == q.shape
    # kv heads that do not divide the q heads: no kernel, and no fallback
    k3 = torch.cat([k, k[:, :, :1]], 2)
    with pytest.raises(ValueError, match="no kernel"):
        F.flash_attention(q, k3, k3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("scale", [-0.2, 0.0])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_forward_takes_any_sign_of_scale(cuda, dtype, scale, masked):
    """A negative scale (the row max of the scaled scores is then the
    scaled min of the raw ones) and scale 0 (every allowed score 0) match
    the plain forward. The limit is that of the same scores written with a
    positive scale: -q at -scale."""
    S = 200
    q, k, v, _ = _flash_case(cuda, 2, S, 3, 64, dtype, seed=9)
    sri = _doc_sri(2, 1, S, 1, True, cuda, seed=S) if masked else None
    out, lse = tfa.flash_fwd(q, k, v, True, scale, sri=sri)
    ro, rl = tfa.flash_attention_fwd_ref(q, k, v, True, scale, sri=sri)
    lim = tfa.kernel_tolerance(-q, k, v, dict(out=ro, lse=rl), True,
                               scale=-scale, sri=sri)
    for name, x, r in (("out", out, ro), ("lse", lse, rl)):
        assert bool(torch.isfinite(x.float()).all()), name
        err = (x.float() - r.float()).abs()
        assert bool((err <= lim[name]).all()), (
            f"{name}: max |kernel - plain| {float(err.max())}, "
            f"{float((err / lim[name]).max())} of the limit")


@pytest.mark.cuda
def test_training_steps_through_the_kernels_match_the_cpu(cuda):
    """Two f32 TrainSteps of a small GPT (head dim 64, GQA) on the card,
    through the flash kernels, against the same steps on the CPU."""
    from paddle_tpu_torch import from_paddle_tpu_state, to_paddle_tpu_state
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import functional as F

    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_position=256)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512,
                                                             (2, 96)))
    state = to_paddle_tpu_state(GPTForCausalLM(cfg, device="cpu", seed=3))
    runs = []
    for dev in (cuda, "cpu"):
        m = from_paddle_tpu_state(state, cfg, device=dev)
        opt = topt.AdamW(learning_rate=1e-4, parameters=m.parameters())
        step = TrainStep(m, lambda logits, loss: loss, opt)
        n0 = tfa.flash_fwd.launches + tfa.flash_bwd_dq.launches + \
            tfa.flash_bwd_dkv.launches
        losses = [float(step(ids, labels=ids.roll(-1, 1))) for _ in range(2)]
        n = tfa.flash_fwd.launches + tfa.flash_bwd_dq.launches + \
            tfa.flash_bwd_dkv.launches - n0
        runs.append((losses, n, F.get_last_attention_backend(),
                     to_paddle_tpu_state(m)))
    (kl, kn, kb, ks), (pl, pn, pb, ps) = runs
    assert (kn, kb, pn, pb) == (3 * 2 * 2, "kernel", 0, "plain")
    np.testing.assert_allclose(kl, pl, rtol=1e-5)
    for name in ks:
        np.testing.assert_allclose(ks[name], ps[name], atol=1e-4, err_msg=name)


def _dense_case(device, B, S, Hkv, G, D, T, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    td = getattr(torch, dtype)
    return [torch.randn(shape, generator=g, device=device).to(td) for shape in
            ((B, S, Hkv * G, D), (B, Hkv, T, D), (B, Hkv, T, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("G,S,D,T,lengths", [
    (1, 1, 64, 640, [512, 639, 575, 0]),     # decode, T = 640
    (4, 1, 128, 300, [3, 299, 64, 100]),     # GQA 4
    (8, 1, 128, 100, [0, 1, 63, 99]),        # GQA 8, T < two tiles
    (1, 64, 64, 200, [0, 136, 17, 70]),      # prefill rows, ragged T
    (4, 5, 64, 77, [0, 72, 11, 40]),
    (1, 129, 128, 129, [0, 0, 0, 0])])       # rows past one tile
def test_decode_attention_kernel_matches_plain(cuda, dtype, G, S, D, T,
                                               lengths):
    q, k, v = _dense_case(cuda, 4, S, 2, G, D, T, dtype, seed=S + G)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == before + 1
    ref = tda.decode_attention_ref(q, k, v, ln)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    assert bool((err <= tda.kernel_tolerance(q, k, v, ln, ref)).all()), (
        f"max |kernel - plain| {float(err.max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("S,length", [(1, 0), (1, 583), (64, 0), (7, 130)])
def test_decode_attention_kernel_takes_one_length_for_the_batch(cuda, S,
                                                                length):
    """An int length (the dense generate() path) runs the kernel on the
    scalar and gives what an int32 [B] tensor of that length gives."""
    q, k, v = _dense_case(cuda, 3, S, 2, 4, 64, 640, "bfloat16", seed=S)
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, k, v, length)
    assert tda.decode_attention.launches == before + 1
    ln = torch.full((3,), length, dtype=torch.int32, device=cuda)
    assert torch.equal(got, tda.decode_attention(q, k, v, ln))
    ref = tda.decode_attention_ref(q, k, v, ln)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= tda.kernel_tolerance(q, k, v, ln, ref)).all())


@pytest.mark.cuda
def test_decode_attention_kernel_rejects_what_it_cannot_run(cuda):
    q, k, v = _dense_case(cuda, 2, 1, 2, 1, 64, 40, "float32")
    with pytest.raises(ValueError, match="head_dim"):
        tda.decode_attention(q[..., :32].contiguous(),
                             k[..., :32].contiguous(),
                             v[..., :32].contiguous(), 5)
    with pytest.raises(TypeError, match="int32"):
        tda.decode_attention(q, k, v, torch.tensor([5, 5], device=cuda))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tda.decode_attention(q.double(), k.double(), v.double(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        tda.decode_attention(q, k.transpose(2, 3).contiguous()
                             .transpose(2, 3), v, 5)
    with pytest.raises(ValueError, match="multiple"):
        tda.decode_attention(torch.cat([q, q[:, :, :1]], 2), k, v, 5)
    with pytest.raises(ValueError, match=">= 0"):
        tda.decode_attention(q, k, v, -1)


def _held_to_plain(q, k, v, ln, got, scale=None):
    ref = tda.decode_attention_ref(q, k, v, ln, scale)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    lim = tda.kernel_tolerance(q, k, v, ln, ref, scale)
    assert bool(torch.isfinite(got).all())
    assert bool((err <= lim).all()), (
        f"max |kernel - plain| {float(err.max())}, "
        f"worst over limit {float((err / lim).max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G,S", [(1, 16), (1, 17), (1, 63), (1, 64),
                                 (1, 65), (4, 4), (4, 5), (4, 16), (4, 17),
                                 (8, 2), (8, 3), (8, 8), (8, 9)])
def test_decode_attention_kernel_forms_meet_at_16_rows(cuda, dtype, D, G, S):
    """S*G rows per (request, kv head) at the forms' threshold (16: decode
    form; 17 and up in bf16 and f16: prefill form) and at one 64-row
    tile's edges,
    GQA 1 / 4 / 8, one request at the full cache (length T - S)."""
    T = 200
    q, k, v = _dense_case(cuda, 4, S, 2, G, D, T, dtype, seed=S * G + D)
    ln = torch.tensor([0, 37, 130, T - S], dtype=torch.int32, device=cuda)
    cfg = tda.kernel_launch_config(4, S, G, 2, T, getattr(torch, dtype))
    assert cfg.form == ("prefill" if dtype != "float32" and S * G > 16
                        else "decode")
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == before + 1
    _held_to_plain(q, k, v, ln, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("scale", [-0.2, 0.0])
@pytest.mark.parametrize("G,S", [(4, 1), (1, 70)])
def test_decode_attention_kernel_takes_any_sign_of_scale(cuda, dtype, scale,
                                                         G, S):
    """The scale is applied before the mask and the max: a negative scale
    and scale 0 (uniform weights over the live prefix) hold to the plain
    version in both forms."""
    q, k, v = _dense_case(cuda, 3, S, 2, G, 64, 300, dtype, seed=S + G)
    ln = torch.tensor([0, 100, 300 - S], dtype=torch.int32, device=cuda)
    got = tda.decode_attention(q, k, v, ln, scale=scale)
    torch.cuda.synchronize()
    _held_to_plain(q, k, v, ln, got, scale)


@pytest.mark.cuda
def test_decode_attention_prefill_writes_the_output_in_one_launch(cuda):
    """generate()'s bf16 prefill (8 requests of 512 rows at length 0, 16
    heads of 64, T = 640) runs unsplit: one kernel, no partials (the call
    allocates nothing beyond its output), within the tolerance."""
    from torch.profiler import ProfilerActivity, profile

    B, S, H, D, T = 8, 512, 16, 64, 640
    q, k, v = _dense_case(cuda, B, S, H, 1, D, T, "bfloat16", seed=3)
    cfg = tda.kernel_launch_config(B, S, 1, H, T)
    assert (cfg.form, cfg.splits) == ("prefill", 1)
    tda.decode_attention(q, k, v, 0)                # build and warm
    gc.collect()        # earlier tests' garbage must not be freed inside
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = tda.decode_attention(q, k, v, 0)
        torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base == got.nbytes
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0]
    assert len(names) == 1 and "dense_prefill_kernel" in names[0], names
    _held_to_plain(q, k, v, 0, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("G,S", [(1, 1), (8, 2), (1, 64), (4, 9)])
def test_decode_attention_split_calls_repeat_and_hold(cuda, dtype, G, S):
    """One request over a long cache runs many splits in either form,
    combined by a second launch: two calls give the same bits, and they
    hold to the plain version."""
    T = 2000
    q, k, v = _dense_case(cuda, 1, S, 2, G, 64, T, dtype, seed=G * S)
    ln = torch.tensor([T - S], dtype=torch.int32, device=cuda)
    cfg = tda.kernel_launch_config(1, S, G, 2, T, getattr(torch, dtype))
    assert cfg.splits > 1
    got = tda.decode_attention(q, k, v, ln)
    again = tda.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _held_to_plain(q, k, v, ln, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("S", [1, 512])
def test_decode_attention_kernel_is_deterministic(cuda, dtype, S):
    """generate()'s shapes (decode and prefill) give the same bits call
    after call."""
    q, k, v = _dense_case(cuda, 8, S, 16, 1, 64, 640, dtype, seed=S)
    ln = torch.randint(0, 640 - S + 1, (8,), dtype=torch.int32, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(S))
    first = tda.decode_attention(q, k, v, ln)
    for _ in range(3):
        assert torch.equal(first, tda.decode_attention(q, k, v, ln))


@pytest.mark.cuda
def test_generate_on_the_card_matches_the_plain_path(cuda):
    """A small GPT (head dim 64) gives the same greedy tokens through the
    dense kernel as through the plain attention path (f32), with one
    kernel launch per layer per forward."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    m = GPTForCausalLM(GPTConfig(vocab_size=1024, hidden_size=128,
                                 num_layers=2, num_heads=2, max_position=128),
                       device=cuda, seed=1)
    prompt = np.arange(22).reshape(2, 11) * 7 % 1024
    before = tda.decode_attention.launches
    got = m.generate(prompt, max_new_tokens=9, dtype=None)
    assert tda.decode_attention.launches == before + 2 * 9
    plain = m.generate(prompt, max_new_tokens=9, dtype=None,
                       decode_kernel="plain")
    assert torch.equal(got, plain)


def _doc_sri(B, Hp, S, n, causal, device, seed=0):
    """A FlashMask for the card tests: n = 1 (causal) the document ends of
    random packed documents, rows >= end hidden; n = 2 (causal) random
    [start, end) bands at or below the diagonal; n = 4 (non-causal) the
    rows outside each column's document ([end, S) and [0, start))."""
    rng = np.random.default_rng(seed)
    cut = np.sort(rng.choice(np.arange(1, S), size=min(6, S - 1),
                             replace=False))
    cu = np.concatenate([[0], cut, [S]])
    seg = np.searchsorted(cu[1:-1], np.arange(S), side="right")
    end, start = cu[seg + 1], cu[seg]
    if n == 1:
        cols = [end]
    elif n == 2:
        lo = rng.integers(np.arange(S), S + 1, (B, Hp, S))
        cols = [lo, lo + rng.integers(0, S // 2, (B, Hp, S))]
    else:
        cols = [end, np.full(S, S), np.zeros(S, np.int64), start]
    cols = [np.broadcast_to(c, (B, Hp, S)) for c in cols]
    return torch.as_tensor(np.stack(cols, -1).astype(np.int32),
                           device=device).contiguous()


def _masked_run(q, k, v, do, causal, sri, plain, scale=None):
    """out, lse, dq, dk and dv of the kernels (their masked forms under
    ``sri``; the unmasked ones for ``sri=None``) or of their plain
    versions; the backward takes the plain forward's lse and delta."""
    ro, rl = tfa.flash_attention_fwd_ref(q, k, v, causal, scale, sri=sri)
    delta = tfa.attention_delta(ro, do)
    if plain:
        out = dict(out=ro, lse=rl, dq=tfa.flash_attention_dq_ref(
            q, k, v, do, rl, delta, causal, scale, sri=sri))
        out["dk"], out["dv"] = tfa.flash_attention_dkv_ref(
            q, k, v, do, rl, delta, causal, scale, sri=sri)
        return out
    o, lse = tfa.flash_fwd(q, k, v, causal, scale, sri=sri)
    out = dict(out=o, lse=lse, dq=tfa.flash_bwd_dq(q, k, v, do, rl, delta,
                                                   causal, scale, sri=sri))
    out["dk"], out["dv"] = tfa.flash_bwd_dkv(q, k, v, do, rl, delta, causal,
                                             scale, sri=sri)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal,n,Hp,S,D", [(True, 1, 1, 256, 64),
                                             (True, 2, 3, 200, 64),
                                             (False, 4, 1, 100, 128),
                                             (True, 1, 3, 1000, 64),
                                             (True, 1, 1, 1025, 128),
                                             (True, 2, 3, 1025, 64),
                                             (False, 4, 3, 1000, 128),
                                             (False, 4, 1, 1025, 64)])
def test_flashmask_kernels_match_plain(cuda, dtype, causal, n, Hp, S, D):
    q, k, v, do = _flash_case(cuda, 2, S, 3, D, dtype, seed=S + n)
    sri = _doc_sri(2, Hp, S, n, causal, cuda, seed=S)
    names = ("fm_fwd", "fm_dq", "fm_dkv", "fwd", "dq", "dkv")
    before = [tfa._WRAPPERS[m].launches for m in names]
    got = _masked_run(q, k, v, do, causal, sri, plain=False)
    torch.cuda.synchronize()
    assert [tfa._WRAPPERS[m].launches for m in names] == [
        b + (i < 3) for i, b in enumerate(before)]
    ref = _masked_run(q, k, v, do, causal, sri, plain=True)
    lim = tfa.kernel_tolerance(q, k, v, ref, causal, dout=do, sri=sri)
    for name, x in got.items():
        assert x.dtype == ref[name].dtype and x.shape == ref[name].shape
        err = (x.float() - ref[name].float()).abs()
        assert bool((err <= lim[name]).all()), (
            f"{name}: max |kernel - plain| {float(err.max())}, "
            f"{float((err / lim[name]).max())} of the limit")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flashmask_kernels_all_masked_and_mask_nothing(cuda, dtype):
    """start 0 under causal hides every row: every output exactly 0. start
    S hides none: bit for bit the unmasked causal kernels."""
    S = 300
    q, k, v, do = _flash_case(cuda, 1, S, 2, 64, dtype, seed=5)
    zero = _masked_run(q, k, v, do, True,
                       torch.zeros((1, 1, S, 1), dtype=torch.int32,
                                   device=cuda), plain=False)
    for name, x in zero.items():
        assert bool((x == 0).all()), name
    none = _masked_run(q, k, v, do, True,
                       torch.full((1, 2, S, 1), S, dtype=torch.int32,
                                  device=cuda), plain=False)
    o, lse = tfa.flash_fwd(q, k, v, True)
    ro, rl = tfa.flash_attention_fwd_ref(q, k, v, True)
    delta = tfa.attention_delta(ro, do)
    plain = dict(out=o, lse=lse,
                 dq=tfa.flash_bwd_dq(q, k, v, do, rl, delta, True))
    plain["dk"], plain["dv"] = tfa.flash_bwd_dkv(q, k, v, do, rl, delta, True)
    for name, x in none.items():
        assert torch.equal(x, plain[name]), name


@pytest.mark.cuda
def test_flashmask_attention_casts_int64_and_its_gradients_match_plain(cuda):
    """An int64 sri (as numpy and torch make it) is cast by the wrapper;
    FlashMaskFunction's gradients (GQA 4/2) against the plain backward on
    the same inputs, in f32."""
    B, S, H, Hkv, D = 2, 190, 4, 2, 64
    g = torch.Generator(device=cuda).manual_seed(11)
    q, do = (torch.randn((B, S, H, D), generator=g, device=cuda)
             for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=cuda)
            for _ in range(2))
    sri = _doc_sri(B, 1, S, 1, True, cuda, seed=12).long()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.flashmask_attention(*leaves, sri, causal=True)
    out.backward(do)
    kr, vr = (x.repeat_interleave(H // Hkv, dim=2) for x in (k, v))
    s32 = sri.to(torch.int32)
    ro, rl = tfa.flash_attention_fwd_ref(q, kr, vr, True, sri=s32)
    grads = tfa.flash_attention_bwd_ref(q, kr, vr, ro, rl, do, True,
                                        sri=s32)
    ref = dict(out=ro, lse=rl, dq=grads[0], dk=grads[1], dv=grads[2])
    lim = tfa.kernel_tolerance(q, kr, vr, ref, True, dout=do, sri=s32)
    assert bool(((out.detach() - ro).abs() <= lim["out"]).all())
    assert bool(((leaves[0].grad - grads[0]).abs() <= lim["dq"]).all())
    for got, want, name in ((leaves[1].grad, grads[1], "dk"),
                            (leaves[2].grad, grads[2], "dv")):
        summed = want.reshape(B, S, Hkv, H // Hkv, D).sum(3)
        bound = lim[name].reshape(B, S, Hkv, H // Hkv, D).sum(3)
        assert bool(((got - summed).abs() <= bound).all()), name
    with pytest.raises(TypeError, match="int32"):
        tfa.flashmask_fwd(q, kr, vr, sri, True)


# ---------------------------------------------------------------- backward
def _within(got, ref, lim, names=("dq", "dk", "dv")):
    for name in names:
        x = got[name]
        assert x.dtype == ref[name].dtype and x.shape == ref[name].shape
        assert bool(torch.isfinite(x.float()).all()), name
        err = (x.float() - ref[name].float()).abs()
        assert bool((err <= lim[name]).all()), (
            f"{name}: max |kernel - plain| {float(err.max())}, "
            f"{float((err / lim[name]).max())} of the limit")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("scale", [-0.2, 0.0])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_backward_takes_any_sign_of_scale(cuda, dtype, scale, masked):
    """dq, dk and dv at a negative scale and at scale 0 (ds then 0) match the
    plain backward. The limit is that of the same scores written with a
    positive scale: -q at -scale."""
    S = 200
    q, k, v, do = _flash_case(cuda, 2, S, 3, 64, dtype, seed=9)
    sri = _doc_sri(2, 1, S, 1, True, cuda, seed=S) if masked else None
    got = _masked_run(q, k, v, do, True, sri, plain=False, scale=scale)
    ref = _masked_run(q, k, v, do, True, sri, plain=True, scale=scale)
    _within(got, ref, tfa.kernel_tolerance(-q, k, v, ref, True, scale=-scale,
                                           dout=do, sri=sri))


def _gap_sri(B, S, causal, device):
    """A FlashMask whose covered 64 x 64 tiles sit between live ones: key
    columns 0..63 hide query rows [64, 128) and columns 64..127 hide every
    row, the others none. The dq walk of query rows 192..255 (and of rows
    0..63 when non-causal) skips key tile 1 between tiles 0 and 2; the
    dk/dv walk of keys 0..63 skips query tile 1 between tiles 0 and 2."""
    c = np.arange(S)
    lo = np.where(c < 64, 64, np.where(c < 128, 0, S))
    hi = np.where(c < 64, 128, S)
    cols = [lo, hi] if causal else [lo, hi, np.zeros(S), np.zeros(S)]
    sri = np.broadcast_to(np.stack(cols, -1), (B, 1, S, len(cols)))
    return torch.as_tensor(sri.astype(np.int32), device=device).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [256, 300])
def test_flashmask_backward_skips_a_covered_tile_inside_the_ring(
        cuda, dtype, causal, S):
    q, k, v, do = _flash_case(cuda, 2, S, 3, 64, dtype, seed=S + causal)
    sri = _gap_sri(2, S, causal, cuda)
    got = _masked_run(q, k, v, do, causal, sri, plain=False)
    ref = _masked_run(q, k, v, do, causal, sri, plain=True)
    _within(got, ref, tfa.kernel_tolerance(q, k, v, ref, causal, dout=do,
                                           sri=sri))
    if causal:      # rows 64..127 see no column: exactly 0
        assert bool((got["dq"][:, 64:128] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_backward_d128_gqa(cuda, dtype, masked):
    """D = 128 with 16 query heads over 4 kv heads, repeated as the wrapper
    repeats them; under a mask per head."""
    B, S, H, Hkv, D = 2, 300, 16, 4, 128
    g = torch.Generator(device=cuda).manual_seed(21)
    td = getattr(torch, dtype)
    q, do = (torch.randn((B, S, H, D), generator=g, device=cuda).to(td)
             for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(td)
            .repeat_interleave(H // Hkv, dim=2) for _ in range(2))
    sri = _doc_sri(B, H, S, 2, True, cuda, seed=22) if masked else None
    got = _masked_run(q, k, v, do, True, sri, plain=False)
    ref = _masked_run(q, k, v, do, True, sri, plain=True)
    _within(got, ref, tfa.kernel_tolerance(q, k, v, ref, True, dout=do,
                                           sri=sri))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_backward_is_deterministic(cuda, dtype, masked):
    """No atomics: two calls give dq, dk and dv bit for bit."""
    S = 1000
    q, k, v, do = _flash_case(cuda, 2, S, 3, 64, dtype, seed=31)
    sri = _doc_sri(2, 1, S, 1, True, cuda, seed=32) if masked else None
    runs = [_masked_run(q, k, v, do, True, sri, plain=False)
            for _ in range(2)]
    for name in ("dq", "dk", "dv"):
        assert torch.equal(runs[0][name], runs[1][name]), name


# ----------------------------------------------- LLaMA-2-7B shapes (D 128)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 64, 5])
def test_paged_attention_kernel_at_llama_2_7b_serving_shapes(cuda, dtype, S):
    """8 slots of LLaMA-2-7B serving (32 kv heads of 128, G 1, block 32):
    decode, a 64-row prefill chunk and a 5-row verify over histories of
    its 128-1500-token prompts, one slot idle."""
    lengths = [0, 128, 1563 - S, 700, 33, 1024, 1499, 257]
    args = _case(cuda, 8, S, 32, 1, 128, 32, lengths, dtype, seed=S)
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention.launches == before + 1
    ref = tpa.paged_decode_attention_ref(*args)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= tpa.kernel_tolerance(*args, ref)).all()), (
        f"max |kernel - plain| {float(err.max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,lengths", [(1, [512, 639, 575, 600]),
                                       (512, [0, 0, 0, 0])])
def test_decode_attention_kernel_at_llama_2_7b_generate_shapes(cuda, dtype,
                                                               S, lengths):
    """generate([4, 512] + 128) of LLaMA-2-7B: 32 kv heads of 128 over
    dense caches of 640 rows, its decode and prefill."""
    q, k, v = _dense_case(cuda, 4, S, 32, 1, 128, 640, dtype, seed=S)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == before + 1
    ref = tda.decode_attention_ref(q, k, v, ln)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= tda.kernel_tolerance(q, k, v, ln, ref)).all()), (
        f"max |kernel - plain| {float(err.max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("B,S,H,D,causal", [(1, 2048, 32, 128, True),
                                            (4, 512, 12, 64, False)])
def test_flash_kernels_at_llama_2_7b_and_bert_base_shapes(cuda, dtype, B, S,
                                                          H, D, causal):
    """llama_train's attention (B 1, S 2048, 32 heads of 128, causal) and
    bert_base's eval forward (S 512, 12 heads of 64, non-causal; B cut to
    4 here)."""
    q, k, v, do = _flash_case(cuda, B, S, H, D, dtype, seed=S)
    out, lse = tfa.flash_fwd(q, k, v, causal)
    ro, rl = tfa.flash_attention_fwd_ref(q, k, v, causal)
    delta = tfa.attention_delta(ro, do)
    got = dict(out=out, lse=lse,
               dq=tfa.flash_bwd_dq(q, k, v, do, rl, delta, causal))
    got["dk"], got["dv"] = tfa.flash_bwd_dkv(q, k, v, do, rl, delta, causal)
    ref = dict(out=ro, lse=rl,
               dq=tfa.flash_attention_dq_ref(q, k, v, do, rl, delta, causal))
    ref["dk"], ref["dv"] = tfa.flash_attention_dkv_ref(q, k, v, do, rl,
                                                       delta, causal)
    lim = tfa.kernel_tolerance(q, k, v, ref, causal, dout=do)
    for name, x in got.items():
        err = (x.float() - ref[name].float()).abs()
        assert bool((err <= lim[name]).all()), (
            f"{name}: max |kernel - plain| {float(err.max())}")
    del q, k, v, do, got, ref, lim
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------- past grid.y's 65535
_PAST = 65535 + 65          # B * H just past grid.y's limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_folds_heads_past_the_grid_limit(cuda, dtype):
    """B * Hkv = 65600 request heads at decode (S = 1, one page each)."""
    B, Hkv, BS, D = _PAST // 4, 4, 16, 64
    g = torch.Generator(device=cuda).manual_seed(11)
    td = getattr(torch, dtype)
    q = torch.randn((B, 1, Hkv, D), generator=g, device=cuda).to(td)
    kp, vp = (torch.randn((Hkv, B, BS, D), generator=g, device=cuda).to(td)
              for _ in range(2))
    tables = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    ln = torch.randint(0, BS, (B,), generator=g, device=cuda,
                       dtype=torch.int32)
    got = tpa.paged_decode_attention(q, kp, vp, tables, ln)
    ref = tpa.paged_decode_attention_ref(q, kp, vp, tables, ln)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= tpa.kernel_tolerance(q, kp, vp, tables, ln,
                                             ref)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,S", [("float32", 1), ("bfloat16", 1),
                                     ("bfloat16", 20)])
def test_decode_attention_kernel_folds_heads_past_the_grid_limit(cuda, dtype,
                                                                 S):
    """B * Hkv = 65600 request heads over a 64-row cache, in the decode
    form and (bf16, 20 rows) the prefill form."""
    B, Hkv, T = _PAST // 4, 4, 64
    q, k, v = _dense_case(cuda, B, S, Hkv, 1, 64, T, dtype, seed=12)
    ln = torch.randint(0, T - S + 1, (B,), dtype=torch.int32, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(3))
    got = tda.decode_attention(q, k, v, ln)
    _held_to_plain(q, k, v, ln, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_fold_heads_past_the_grid_limit(cuda, dtype):
    """B * H = 65600 heads of 64 rows: forward, dq and dk/dv."""
    q, k, v, do = _flash_case(cuda, _PAST // 64, 64, 64, 64, dtype, seed=13)
    out, lse = tfa.flash_fwd(q, k, v, True)
    ro, rl = tfa.flash_attention_fwd_ref(q, k, v, True)
    delta = tfa.attention_delta(ro, do)
    got = dict(out=out, lse=lse,
               dq=tfa.flash_bwd_dq(q, k, v, do, rl, delta, True))
    got["dk"], got["dv"] = tfa.flash_bwd_dkv(q, k, v, do, rl, delta, True)
    ref = dict(out=ro, lse=rl,
               dq=tfa.flash_attention_dq_ref(q, k, v, do, rl, delta, True))
    ref["dk"], ref["dv"] = tfa.flash_attention_dkv_ref(q, k, v, do, rl,
                                                       delta, True)
    lim = tfa.kernel_tolerance(q, k, v, ref, True, dout=do)
    for name, x in got.items():
        err = (x.float() - ref[name].float()).abs()
        assert bool((err <= lim[name]).all()), name
