"""Dense split-KV attention of the PyTorch port, held against the JAX
package's plain reference (``decode_attention_xla``, i.e.
``decode_attention(kernel="xla")``) on the same numpy inputs, at the shapes
of ``test_splitkv_parity`` and ``test_splitkv_per_request_lengths_and_prefill``
(tests/test_decode_attention.py).

Tolerances: f32 1e-5 (the same arithmetic, summed in another order); bf16
the elementwise bound of ``kernel_tolerance``, 2^-7 (|ref| + sum_j p_j |v_j|)
(both sides round probabilities and the output to bf16, at slightly
different places), which a mask one column short breaks; f16 the same
bound with 2^-10 (f16 keeps 11 significant bits). The CUDA kernel
is held against the port's plain version on the card in
``test_torch_cuda_kernels.py``; here its bf16 limit (``kernel_tolerance``)
is checked against a CPU emulation of the kernel's rounding, in the order
each of its two forms walks the cache.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu_torch.ops import decode_attention as tda

F32_TOL = 1e-5


def _inputs(seed, B, S, Hq, Hkv, D, T):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((B, S, Hq, D), (B, Hkv, T, D), (B, Hkv, T, D)))


def _jax_ref(q, k, v, lengths, dtype):
    jd = getattr(jnp, dtype)
    out = jda.decode_attention(jnp.asarray(q).astype(jd),
                               jnp.asarray(k).astype(jd),
                               jnp.asarray(v).astype(jd),
                               jnp.asarray(lengths, jnp.int32), kernel="xla")
    return np.array(out.astype(jnp.float32))      # writable, for torch


def _torch(arrays, dtype):
    return tuple(torch.from_numpy(a).to(getattr(torch, dtype))
                 for a in arrays)


def _assert_close_to_jax(args, lengths, dtype):
    """The port's plain version against JAX's on the same inputs: f32
    within 1e-5; bf16 elementwise within ``kernel_tolerance``, a bound the
    same plain version with every length one short must break."""
    ref = _jax_ref(*args, lengths, dtype)
    targs = _torch(args, dtype)
    tlens = (torch.from_numpy(lengths) if isinstance(lengths, np.ndarray)
             else lengths)
    got = tda.decode_attention_ref(*targs, tlens)
    assert got.dtype == getattr(torch, dtype)
    err = (got.float() - torch.from_numpy(ref)).abs()
    if dtype == "float32":
        assert float(err.max()) <= F32_TOL
        return got
    lim = tda.kernel_tolerance(*targs, tlens, got)
    assert bool((err <= lim).all()), float((err / lim).max())
    short = tda.decode_attention_ref(*targs, tlens - 1)
    assert bool(((short.float() - torch.from_numpy(ref)).abs() > lim).any())
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("gqa", [1, 4, 8])
def test_plain_decode_attention_matches_jax_reference(dtype, gqa):
    """S = 1 over a 64-row cache at length 37 (no block multiple), GQA
    1 / 4 / 8, lengths as a Python int."""
    B, S, Hq, D, T = 2, 1, 8, 16, 64
    args = _inputs(0, B, S, Hq, Hq // gqa, D, T)
    got = _assert_close_to_jax(args, 37, dtype)
    assert got.shape == (B, S, Hq, D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_per_request_lengths_and_prefill_match_jax(dtype):
    """S = 5 new rows (prefill into the cache) at per-request lengths 11
    and 60 of a 96-row cache, GQA 2, lengths as an int32 [B] tensor."""
    args = _inputs(1, 2, 5, 4, 2, 16, 96)
    _assert_close_to_jax(args, np.array([11, 60], np.int32), dtype)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    args = _torch(_inputs(3, 2, 3, 4, 2, 16, 40), "float32")
    before = tda.decode_attention.launches
    for lengths in (9, torch.tensor([9, 9], dtype=torch.int32)):
        got = tda.decode_attention(*args, lengths)
        torch.testing.assert_close(got, tda.decode_attention_ref(*args, 9),
                                   atol=0, rtol=0)
    assert tda.decode_attention.launches == before      # no kernel ran


def test_kernel_launch_config_covers_the_grid():
    """Every tile lies in exactly one split; bf16 calls past 16 rows per
    (request, kv head) take the prefill form, the rest (and f32) the decode
    form; generate()'s prefill and decode run unsplit (their blocks write
    the output directly); and short batches split to fill the card where
    the cache allows."""
    for B, S, G, Hkv, T in [(8, 1, 1, 16, 640), (8, 512, 1, 16, 640),
                            (1, 1, 8, 2, 100), (3, 70, 4, 2, 1000),
                            (2, 1, 1, 1, 64), (1, 16, 1, 16, 2048),
                            (1, 17, 1, 16, 2048), (2, 4, 4, 2, 300),
                            (2, 5, 4, 2, 300), (1, 256, 1, 16, 336)]:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            cfg = tda.kernel_launch_config(B, S, G, Hkv, T, dtype)
            big = dtype != torch.float32 and S * G > 16
            assert cfg.form == ("prefill" if big else "decode")
            assert cfg.rows == (64 if big else 16)
            num_tiles = -(-T // 64)
            tps, splits = cfg.tiles_per_split, cfg.splits
            assert splits * tps >= num_tiles > (splits - 1) * tps
            # one block per SM at most, a split streaming 8 tiles or more
            # in bf16 (any number in f32), and no fewer splits than that
            # allows, give or take the rounding of tiles per split
            base = B * Hkv * -(-(S * G) // cfg.rows)
            least = 1 if dtype == torch.float32 else 8
            assert splits == 1 or (splits * base <= 132 and tps >= least)
            want = max(1, min(132 // base, num_tiles // least))
            assert splits >= want * 3 // 4
    prefill = tda.kernel_launch_config(8, 512, 1, 16, 640)
    assert (prefill.form, prefill.splits) == ("prefill", 1)
    decode = tda.kernel_launch_config(8, 1, 1, 16, 640)
    assert (decode.form, decode.splits) == ("decode", 1)
    single = tda.kernel_launch_config(1, 1, 1, 16, 4096)
    assert (single.form, single.splits) == ("decode", 8)


def _streams(cfg, T):
    """The kernel's walk of the cache as streams of column chunks, each
    with its own running max: per split, the 64-column tiles (prefill
    form), or each warp's 16 columns of every tile (decode form)."""
    tiles = -(-T // 64)
    for j in range(cfg.splits):
        own = range(j * cfg.tiles_per_split,
                    min((j + 1) * cfg.tiles_per_split, tiles))
        if cfg.form == "prefill":
            yield [(t * 64, 64) for t in own]
        else:
            for w in range(4):
                yield [(t * 64 + 16 * w, 16) for t in own]


def _kernel_arithmetic(q, k, v, lengths):
    """The 16-bit kernel's rounding on the CPU, in its form's order
    (``kernel_launch_config``): f32 scores; along each stream of
    ``_streams`` the unnormalised probabilities rounded to the cache dtype
    against the stream's running max before P.V, l summing them unrounded;
    the streams (warps, then splits) merged in f32 by their final maxima;
    one division by l, the output rounded to the cache dtype once."""
    B, S, Hq, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    pad = -T % 64
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    sc = torch.einsum("bsngd,bntd->bngst",
                      q.reshape(B, S, Hkv, G, D).float(), kf) / D ** 0.5
    pos_q = lengths.long()[:, None] + torch.arange(S)
    allowed = torch.arange(T + pad)[None, None] <= pos_q[:, :, None]
    allowed &= torch.arange(T + pad)[None, None] < T
    sc = sc.masked_fill(~allowed[:, None, None], -float("inf"))
    parts = []                                   # (m, l, o) per stream
    for chunks in _streams(tda.kernel_launch_config(B, S, G, Hkv, T,
                                                    k.dtype), T):
        if not chunks:
            continue
        cols = torch.cat([torch.arange(c0, c0 + w) for c0, w in chunks])
        width = chunks[0][1]
        s = sc[..., cols]
        m = s.reshape(*s.shape[:-1], -1, width).amax(-1).cummax(-1).values
        m = m.repeat_interleave(width, -1)      # running max per chunk
        p = torch.exp(s - m).nan_to_num()
        w = torch.exp(m - m[..., -1:]).nan_to_num()  # to the final max
        o = torch.einsum("bngst,bntd->bngsd",
                         p.to(k.dtype).float() * w, vf[:, :, cols])
        parts.append((m[..., -1], (p * w).sum(-1), o))
    m_star = torch.stack([m for m, _, _ in parts]).amax(0)
    l = sum(l * torch.exp(m - m_star).nan_to_num() for m, l, _ in parts)
    o = sum(o * torch.exp(m - m_star).nan_to_num()[..., None]
            for m, _, o in parts)
    out = o / l.clamp(min=1e-30)[..., None]           # [B, Hkv, G, S, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(k.dtype)


@pytest.mark.parametrize("G,S", [(1, 1), (4, 1), (1, 40), (4, 5)])
def test_kernel_tolerance_covers_bf16_rounding_and_flags_a_short_length(G, S):
    """The bf16 limit the kernel is held to on the card admits the kernel's
    own rounding and rejects a mask one column short."""
    _check_tolerance(G, S, "bfloat16")


@pytest.mark.parametrize("G,S", [(1, 1), (4, 1), (1, 40), (4, 5)])
def test_kernel_tolerance_covers_f16_rounding_and_flags_a_short_length(G, S):
    """The same for f16 caches, whose limit is 2^-10 in place of 2^-7."""
    _check_tolerance(G, S, "float16")


def _check_tolerance(G, S, dtype):
    Hkv, D, T = 2, 64, 200                       # T no multiple of 64
    lengths = torch.tensor([0, 1, 37, 120, 200 - S], dtype=torch.int32)
    q, k, v = _torch(_inputs(5 + G + S, 5, S, Hkv * G, Hkv, D, T), dtype)
    ref = tda.decode_attention_ref(q, k, v, lengths)
    lim = tda.kernel_tolerance(q, k, v, lengths, ref)
    assert float(lim.median()) < 0.2 * float(ref.float().abs().median())
    got = _kernel_arithmetic(q, k, v, lengths)
    assert bool(((got.float() - ref.float()).abs() <= lim).all())
    short = _kernel_arithmetic(q, k, v, (lengths - 1).clamp(min=0))
    assert bool(((short.float() - ref.float()).abs() > lim).any())


def test_paged_plain_version_is_the_dense_one_on_the_gathered_cache():
    """The paged plain version is JAX's gather path followed by the dense
    reference, as ``paged_decode_attention(kernel="xla")`` is."""
    from paddle_tpu_torch.ops import paged_attention as tpa

    rng = np.random.default_rng(9)
    B, S, Hq, Hkv, D, BS, P, NB = 2, 3, 4, 2, 16, 8, 8, 3
    q = torch.from_numpy(rng.standard_normal((B, S, Hq, D)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((Hkv, P, BS, D))
                               .astype(np.float32)) for _ in range(2))
    tables = torch.tensor([[5, 2, 0], [7, 1, 3]], dtype=torch.int32)
    lengths = torch.tensor([4, 19], dtype=torch.int32)
    dense = [x[:, tables.long()].reshape(Hkv, B, NB * BS, D).transpose(0, 1)
             for x in (kp, vp)]
    torch.testing.assert_close(
        tpa.paged_decode_attention_ref(q, kp, vp, tables, lengths),
        tda.decode_attention_ref(q, *dense, lengths), atol=0, rtol=0)
