"""Paged attention and paged cache writes of the PyTorch port, held against
the JAX package's plain reference path (``kernel="xla"``: the table gather
followed by ``decode_attention_xla``) on the same numpy inputs.

Tolerances: f32 1e-5 (the same arithmetic, summed in another order);
bf16 3e-2 (both sides round probabilities to bf16 before P.V, at slightly
different places). The CUDA kernel is held against the port's plain
version on the card in ``test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu_torch.ops import paged_attention as tpa

_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(seed, B, S, Hq, Hkv, D, BS, P, NB, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((Hkv, P, BS, D)).astype(np.float32)
    vp = rng.standard_normal((Hkv, P, BS, D)).astype(np.float32)
    tables = np.zeros((B, NB), np.int32)
    pages = rng.permutation(P)
    used = 0
    for b in range(B):
        n = -(-(lengths[b] + S) // BS)          # pages the request spans
        tables[b, :n] = pages[used:used + n]    # the rest stays page 0
        used += n
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _jax_ref(q, kp, vp, tables, lengths, dtype):
    jd = getattr(jnp, dtype)
    out = jda.paged_decode_attention(
        jnp.asarray(q).astype(jd), jnp.asarray(kp).astype(jd),
        jnp.asarray(vp).astype(jd), jnp.asarray(tables),
        jnp.asarray(lengths), kernel="xla")
    return np.asarray(out.astype(jnp.float32))


def _torch_args(q, kp, vp, tables, lengths, dtype, device="cpu"):
    td = getattr(torch, dtype)
    return (torch.from_numpy(q).to(device, td),
            torch.from_numpy(kp).to(device, td),
            torch.from_numpy(vp).to(device, td),
            torch.from_numpy(tables).to(device),
            torch.from_numpy(lengths).to(device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S", [1, 5])
def test_plain_paged_attention_matches_jax_reference(dtype, G, S):
    Hkv, D, BS = 2, 16, 8
    lengths = [3, 13, 0, 21]            # none a block multiple; one empty
    args = _inputs(7 + G + S, 4, S, Hkv * G, Hkv, D, BS, 16, 4, lengths)
    ref = _jax_ref(*args, dtype)
    got = tpa.paged_decode_attention_ref(*_torch_args(*args, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=_TOL[dtype],
                               rtol=0)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    args = _inputs(3, 2, 3, 4, 2, 16, 8, 8, 3, [5, 9])
    targs = _torch_args(*args, "float32")
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(*targs)
    assert tpa.paged_decode_attention.launches == before   # no kernel ran
    torch.testing.assert_close(got, tpa.paged_decode_attention_ref(*targs),
                               atol=0, rtol=0)


@pytest.mark.parametrize("with_valid", [False, True])
def test_write_positions_matches_jax(with_valid):
    lengths = np.array([0, 5, 17], np.int32)
    valid = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0]], bool)
    kw = dict(valid=valid, capacity=24) if with_valid else {}
    ref = np.asarray(jda.write_positions(jnp.asarray(lengths), 4, **kw))
    got = tpa.write_positions(torch.from_numpy(lengths), 4, **kw)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_cache_update_matches_jax_and_drops_padding(dtype):
    """Rows pushed to the capacity (padding, write ceiling) vanish on both
    sides: the port masks them where XLA drops an out-of-bounds scatter."""
    rng = np.random.default_rng(11)
    B, S, Hkv, D, BS, P, NB = 3, 4, 2, 16, 8, 10, 3
    kp = rng.standard_normal((Hkv, P, BS, D)).astype(np.float32)
    vp = rng.standard_normal((Hkv, P, BS, D)).astype(np.float32)
    kn = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    tables = np.array([[4, 1, 0], [7, 2, 9], [3, 0, 0]], np.int32)
    lengths = np.array([6, 20, 0], np.int32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 0, 0]], bool)
    pos = np.array(jda.write_positions(jnp.asarray(lengths), S,
                                       valid=jnp.asarray(valid),
                                       capacity=NB * BS))
    assert (pos >= NB * BS).any()       # some rows are dropped ...
    assert (pos[1] == [20, 21, 22, 23]).all()   # ... and some cross pages
    jd = getattr(jnp, dtype)
    rk, rv = jda.paged_cache_update(
        jnp.asarray(kp).astype(jd), jnp.asarray(vp).astype(jd),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(tables),
        jnp.asarray(pos))
    td = getattr(torch, dtype)
    tk = torch.from_numpy(kp).to(td)
    tv = torch.from_numpy(vp).to(td)
    out_k, out_v = tpa.paged_cache_update(
        tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(tables), torch.from_numpy(pos))
    assert out_k is tk and out_v is tv          # updated in place
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(rk.astype(jnp.float32)))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(rv.astype(jnp.float32)))


@pytest.mark.parametrize("B,S,G,Hkv,NB,BS", [
    (8, 1, 1, 16, 32, 32),      # decode at the serving shape
    (8, 64, 1, 16, 32, 32),     # a prefill chunk at the serving shape
    (1, 1, 8, 2, 4, 16),        # few columns: fewer blocks than the card
    (3, 70, 4, 2, 9, 128),      # rows past one tile; a tile is half a page
    (2, 5, 4, 4, 64, 64),       # speculative verify rows, GQA 4
    (1, 1, 1, 1, 2048, 16),     # one request, a long context
    (64, 1, 1, 16, 4096, 16),   # a long context and a large batch: the
                                # cap of 32 * BS tiles per split binds
    (16, 1, 2, 8, 40, 16),      # a large batch: one split suffices
])
def test_kernel_launch_config_covers_the_grid(B, S, G, Hkv, NB, BS):
    """Every query row falls in a row tile; every column below NB * BS
    falls in exactly one split; at decode the grid has at least 4 blocks per
    SM of 132 wherever the columns allow that many."""
    row_tiles, tps, splits = tpa.kernel_launch_config(B, S, G, Hkv, NB, BS)
    assert (row_tiles - 1) * 64 < S * G <= row_tiles * 64
    cols = np.arange(NB * BS)
    owner = cols // (tps * 64)                  # the split each column is in
    starts = np.arange(splits) * tps * 64
    assert ((owner >= 0) & (owner < splits)).all()
    assert (np.searchsorted(starts, cols, side="right") - 1 == owner).all()
    assert starts[-1] < NB * BS                 # no split is empty
    assert -(-(tps * 64) // BS) + 1 <= 2049     # page ids a block keeps
    if S == 1:
        blocks = splits * B * Hkv * row_tiles
        assert blocks >= min(4 * 132, B * Hkv * row_tiles * -(-NB * BS // 64))


def _kernel_arithmetic(q, kp, vp, tables, lengths):
    """The bf16 kernel's rounding on the CPU: f32 scores, unnormalised
    probabilities rounded to bf16 before P.V (per 64-column tile, against
    the running max), f32 sums, one division by l, the output rounded to
    bf16 once."""
    B, S, Hq, D = q.shape
    Hkv, _, BS, _ = kp.shape
    G, T = Hq // Hkv, tables.shape[1] * BS
    tbl = tables.long()
    kd = kp[:, tbl].reshape(Hkv, B, T, D).transpose(0, 1).float()
    vd = vp[:, tbl].reshape(Hkv, B, T, D).transpose(0, 1).float()
    sc = torch.einsum("bsngd,bntd->bngst", q.reshape(B, S, Hkv, G, D).float(),
                      kd) / D ** 0.5
    pos_q = lengths.long()[:, None] + torch.arange(S)
    allowed = torch.arange(T)[None, None] <= pos_q[:, :, None]
    sc = sc.masked_fill(~allowed[:, None, None], -float("inf"))
    m = sc.reshape(*sc.shape[:-1], -1, 64).amax(-1).cummax(-1).values
    m = m.repeat_interleave(64, -1)              # running max per tile
    p = torch.exp(sc - m).nan_to_num()
    w = torch.exp(m - m[..., -1:]).nan_to_num()  # rescale to the final max
    l = (p * w).sum(-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() * w
    out = torch.einsum("bngst,bntd->bsngd", pv / l.clamp(min=1e-30), vd)
    return out.reshape(B, S, Hq, D).to(torch.bfloat16)


@pytest.mark.parametrize("G,S", [(1, 1), (4, 1), (1, 24), (4, 5)])
def test_kernel_tolerance_covers_bf16_rounding_and_flags_a_short_length(G, S):
    """The bf16 limit the kernel is held to on the card admits the kernel's
    own rounding and rejects a mask one column short."""
    Hkv, D, BS = 2, 64, 32
    lengths = [0, 1, 37, 300, 511]              # short rows cancel least
    args = _torch_args(*_inputs(5 + G + S, 5, S, Hkv * G, Hkv, D, BS, 90,
                                18, lengths), "bfloat16")
    ref = tpa.paged_decode_attention_ref(*args)
    lim = tpa.kernel_tolerance(*args, ref)
    assert float(lim.median()) < 0.2 * float(ref.float().abs().median())
    got = _kernel_arithmetic(*args)
    assert bool(((got.float() - ref.float()).abs() <= lim).all())
    q, kp, vp, tbl, ln = args
    short = _kernel_arithmetic(q, kp, vp, tbl, (ln - 1).clamp(min=0))
    assert bool(((short.float() - ref.float()).abs() > lim).any())
