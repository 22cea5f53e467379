"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a GPU.

This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances are each module's ``kernel_tolerance``, elementwise. Paged
attention: f32 1e-4 (another summation order over up to ~1k columns); bf16
2^-7 (|ref| + sum_j p_j |v_j|) (unnormalised probabilities and the output
rounded to bf16 at other places than the plain version's). Flash attention:
2^-7 (|ref| + the magnitude of the sum) for bf16 plus 2^-16 of the f32 sums'
magnitude for another summation order (``flash_attention.kernel_tolerance``
states each term).
"""
import numpy as np
import pytest
import torch

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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,S,BS,D", [(1, 1, 32, 64), (4, 1, 16, 64),
                                      (1, 64, 32, 64), (4, 5, 64, 128),
                                      (8, 3, 128, 64), (1, 128, 32, 128)])
def test_paged_attention_kernel_matches_plain(cuda, dtype, G, S, BS, D):
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,S,D", [(True, 256, 64), (False, 100, 64),
                                        (True, 77, 128), (False, 1, 128),
                                        (True, 1000, 64)])
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
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_fwd(q.half(), k.half(), v.half())
    from paddle_tpu_torch.nn import functional as F
    with pytest.raises(NotImplementedError, match="dropout"):
        F.flash_attention(q, k, v, dropout=0.1)
    with pytest.raises(ValueError, match="no kernel"):
        F.flash_attention(q, k[:, :8], v[:, :8])


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
