"""Dense ``generate()``, whole-batch ``generate_paged()`` and the whole-batch
predictor of the PyTorch port, held against the JAX package.

The same weights (moved over as numpy arrays by ``bridge.py``) and the same
numpy prompts go through JAX ``generate(decode_kernel="xla", dtype=None)``
(f32) and through the port (whose kernel wrappers run their plain versions
on CPU tensors):

* the dense cache branch's logits (a prefill forward, then a one-token
  decode forward over the written cache) agree with JAX's cache-free
  forward within 1e-4 (f32 sums in another order);
* greedy tokens are identical, after asserting a top-1 / top-2 logit
  margin of 1e-3 (far above that tolerance) at every greedy pick, since
  f32 near-ties would otherwise make token identity a coin flip;
* EOS freezes the remainder, and the bucketed cache length is the JAX
  program's (prompt + ``bucket_new_tokens(n)``);
* mixed-length batches through ``generate_paged`` and the whole-batch
  predictor give each request its dense tokens, and a pool whose signature
  does not match the model degrades to dense ``generate()`` with JAX's
  tokens, leaving the pool untouched.

Sampled tokens cannot match ``jax.random``; the first sampled token's law
is pinned by a chi-square test against the exact softmax of the target's
(JAX) logits.
"""
import io
import threading
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.inference import (
    ContinuousGenerateBatchingPredictor,
    GenerateBatchingPredictor,
    InferenceServer,
    PagedKVCache,
)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.generation import bucket_new_tokens

LOGIT_TOL = 1e-4
MARGIN = 1e-3           # top-1 minus top-2 logit; > 2 * LOGIT_TOL
SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_position=64)     # the chaos tests' model


def _pair(cfg_kw, seed):
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg_kw))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    return jm, from_paddle_tpu_state(state, tgpt.GPTConfig(**cfg_kw),
                                     device="cpu")


@pytest.fixture(scope="module")
def tiny():
    """(JAX gpt_tiny, port model with the same weights)."""
    return _pair(dict(vocab_size=1024, hidden_size=64, num_layers=2,
                      num_heads=4, max_position=128), 7)


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL, 7)


def _jax_generate(jm, ids, n, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(np.asarray(ids)),
                                  max_new_tokens=n, dtype=None,
                                  decode_kernel="xla", **kw)._value)


@torch.no_grad()
def _assert_margins(tm, out, P):
    """Every greedy pick of ``out`` [B, P + n] had a top-1 / top-2 margin
    above MARGIN in the port's cache-free forward."""
    lg = tm(torch.tensor(np.asarray(out))).float()[:, P - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    assert bool((gap > MARGIN).all()), f"near-tie: min margin {gap.min()}"


@torch.no_grad()
def test_dense_cache_logits_match_jax_forward(tiny):
    """A prefill forward over the dense caches, then a one-token decode
    forward over what it wrote, against JAX's cache-free forward."""
    jm, tm = tiny
    ids = np.random.default_rng(1).integers(0, 1024, (2, 7))
    ref = np.asarray(jm(paddle.to_tensor(ids))._value)
    L, Hkv, D = tm._decode_cache_spec()
    kc = [torch.zeros(2, Hkv, 16, D) for _ in range(L)]
    vc = [torch.zeros(2, Hkv, 16, D) for _ in range(L)]
    pre = tm._decode_call(None, torch.as_tensor(ids[:, :6]), kc, vc,
                          tgpt.DenseStep(0), "kernel")
    dec = tm._decode_call(None, torch.as_tensor(ids[:, 6:]), kc, vc,
                          tgpt.DenseStep(6), "kernel")
    got = torch.cat([pre, dec], dim=1).numpy()
    np.testing.assert_allclose(got, ref, atol=LOGIT_TOL, rtol=0)
    assert all(bool((c[:, :, 7:] == 0).all()) for c in kc + vc)


def test_generate_greedy_tokens_match_jax(tiny):
    jm, tm = tiny
    ids = np.random.default_rng(0).integers(0, 1024, (2, 5))
    got = tm.generate(ids, max_new_tokens=6, dtype=None)
    assert got.dtype == torch.int64 and got.shape == (2, 11)
    _assert_margins(tm, got, 5)
    np.testing.assert_array_equal(got.numpy(), _jax_generate(jm, ids, 6))
    np.testing.assert_array_equal(got[:, :5].numpy(), ids)
    plain = tm.generate(ids, max_new_tokens=6, dtype=None,
                        decode_kernel="plain")
    assert torch.equal(got, plain)


def test_eos_freezes_the_remainder_like_jax(tiny):
    jm, tm = tiny
    ids = np.random.default_rng(2).integers(0, 1024, (2, 6))
    probe = tm.generate(ids, max_new_tokens=8, dtype=None).numpy()
    _assert_margins(tm, probe, 6)
    eos = int(probe[0, 6 + 2])                  # row 0 hits it mid-run
    got = tm.generate(ids, max_new_tokens=8, dtype=None,
                      eos_token_id=eos).numpy()
    assert (got[0, 6 + 2:] == eos).all()
    np.testing.assert_array_equal(got, _jax_generate(jm, ids, 8,
                                                     eos_token_id=eos))


def test_bucketed_cache_length_and_truncation(tiny, monkeypatch):
    """The caches hold prompt + bucket_new_tokens(n) rows, as the JAX
    program's do; n = 5 (bucket 8) gives the first 5 tokens of n = 8."""
    _, tm = tiny
    for n in (0, 1, 2, 3, 5, 8, 9, 31, 33, 128):
        assert bucket_new_tokens(n) == jgen.bucket_new_tokens(n)
    seen = []
    real = tgpt.decode_attention

    def spy(q, k_cache, v_cache, lengths, scale=None):
        seen.append(k_cache.shape[2])
        return real(q, k_cache, v_cache, lengths, scale)

    monkeypatch.setattr(tgpt, "decode_attention", spy)
    ids = np.random.default_rng(3).integers(0, 1024, (1, 4))
    five = tm.generate(ids, max_new_tokens=5, dtype=None)
    assert set(seen) == {4 + 8} and len(seen) == 2 * 5   # layers x forwards
    eight = tm.generate(ids, max_new_tokens=8, dtype=None)
    assert torch.equal(five, eight[:, :4 + 5])


def test_generate_timing_hook_and_deadline_gate(tiny):
    """The timing hook gets one record per call, ``compiled`` True only on
    the call that built the key's runner (budgets 5 and 7 share bucket 8);
    an expired deadline raises before any forward runs (JAX
    ``generation.py:222-281``)."""
    from paddle_tpu_torch.inference import Deadline, DeadlineExceeded

    _, tm = tiny
    ids = np.random.default_rng(4).integers(0, 1024, (3, 4))
    seen = []
    tm.generate(ids, max_new_tokens=5, dtype=None, timing_hook=seen.append)
    assert len(seen) == 1
    rec = seen[0]
    assert (rec["path"], rec["batch"], rec["prompt_len"],
            rec["new_tokens"], rec["compiled"],
            rec["flops"]) == ("dense", 3, 4, 5, True, None)
    assert rec["launch_s"] > 0 and rec["per_token_s"] == rec["launch_s"] / 5
    tm.generate(ids, max_new_tokens=7, dtype=None, timing_hook=seen.append)
    assert (seen[1]["new_tokens"], seen[1]["compiled"]) == (7, False)
    with pytest.raises(DeadlineExceeded):
        tm.generate(ids, max_new_tokens=5, dtype=None,
                    deadline=Deadline.after(-1.0), timing_hook=seen.append)
    assert len(seen) == 2


@torch.no_grad()
def test_dense_write_past_the_cache_end_raises(tiny):
    _, tm = tiny
    L, Hkv, D = tm._decode_cache_spec()
    kc = [torch.zeros(1, Hkv, 8, D) for _ in range(L)]
    vc = [torch.zeros(1, Hkv, 8, D) for _ in range(L)]
    with pytest.raises(ValueError, match="pass its end"):
        tm._decode_call(None, torch.zeros((1, 2), dtype=torch.int64), kc, vc,
                        tgpt.DenseStep(7), "kernel")


def _mixed(rng, lens, vocab):
    return [rng.integers(0, vocab, n).astype(np.int64) for n in lens]


def test_generate_paged_mixed_lengths_match_dense(small):
    """The twin of test_generate_paged_mixed_lengths_match_dense
    (tests/test_decode_attention.py:278), against JAX's dense tokens."""
    jm, tm = small
    NEW = 5
    prompts = _mixed(np.random.default_rng(0), (5, 9, 3), 128)
    refs = [_jax_generate(jm, p[None], NEW)[0] for p in prompts]
    for p, ref in zip(prompts, refs):
        _assert_margins(tm, ref[None], len(p))
    cache = PagedKVCache(*tm._decode_cache_spec(), block_size=8,
                         num_blocks=24, dtype=torch.float32, device="cpu")
    plens = np.asarray([len(p) for p in prompts])
    batch = np.zeros((3, plens.max()), np.int64)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    nb = max(cache.blocks_for(int(n) + NEW) for n in plens)
    for i in range(3):
        cache.reserve(i, int(plens[i]) + NEW)
    tables = np.stack([cache.block_table(i, pad_to=nb) for i in range(3)])
    toks = tm.generate_paged(batch, plens, cache, tables,
                             max_new_tokens=NEW)
    assert toks.shape == (3, NEW)
    for i, (p, ref) in enumerate(zip(prompts, refs)):
        np.testing.assert_array_equal(toks[i], ref[len(p):], err_msg=str(i))
        np.testing.assert_array_equal(
            tm.generate(p[None], NEW, dtype=None)[0].numpy(), ref)


def _serve_concurrently(gp, prompts):
    results = {}
    ts = [threading.Thread(target=lambda i=i: results.update(
        {i: gp.infer(prompts[i], timeout=120)})) for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return [results[i] for i in range(len(prompts))]


def test_generate_batching_predictor_serves_mixed_lengths(small):
    """The twin of test_generate_batching_predictor_serves_mixed_lengths
    (tests/test_decode_attention.py:341): concurrent mixed-length requests
    batch together over the shared pool and get JAX's dense tokens; one
    more goes over HTTP; the pool drains."""
    jm, tm = small
    NEW = 4
    prompts = _mixed(np.random.default_rng(0), (4, 7), 128)
    refs = [_jax_generate(jm, p[None], NEW)[0] for p in prompts]
    for p, ref in zip(prompts, refs):
        _assert_margins(tm, ref[None], len(p))
    gp = GenerateBatchingPredictor(tm, max_batch_size=4, max_delay_ms=30,
                                   max_new_tokens=NEW, block_size=8,
                                   num_blocks=16, device="cpu")
    srv = InferenceServer(gp, device="cpu").start()
    try:
        assert not gp.fallback_dense
        got = _serve_concurrently(gp, prompts)
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(got[i], ref, err_msg=f"req {i}")
        buf = io.BytesIO()
        np.savez(buf, ids=prompts[1])
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/generate",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out = np.load(io.BytesIO(r.read()))["out0"]
        np.testing.assert_array_equal(out, refs[1])
        snap = gp.metrics.snapshot()
        assert snap["accepted"] == snap["completed"] == 3
        assert sum(gp.batch_sizes) == 3
    finally:
        srv.stop()
    assert gp.kv_cache.blocks_in_use == 0
    gp.kv_cache.check_conservation()


@torch.no_grad()
def test_whole_batch_pads_the_batch_to_a_power_of_two(small, monkeypatch):
    """Three requests in one batch run as one generate_paged call of B = 4
    (max_batch_size 8), the padding row writing only the scratch page: the
    real rows' tokens equal JAX's dense tokens and an unpadded call's, and
    the live pages [:, :num_blocks] are bit-equal to the unpadded call's."""
    from paddle_tpu_torch.inference.serving import _Request

    jm, tm = small
    NEW = 4
    prompts = _mixed(np.random.default_rng(3), (6, 3, 9), 128)
    refs = [_jax_generate(jm, p[None], NEW)[0] for p in prompts]
    for p, ref in zip(prompts, refs):
        _assert_margins(tm, ref[None], len(p))
    gp = GenerateBatchingPredictor(tm, max_batch_size=8, max_new_tokens=NEW,
                                   block_size=8, num_blocks=16, device="cpu")
    shapes = []
    real_generate_paged = tm.generate_paged

    def spy(ids, *a, **k):
        shapes.append(np.asarray(ids).shape)
        return real_generate_paged(ids, *a, **k)

    monkeypatch.setattr(tm, "generate_paged", spy)
    try:
        reqs = [_Request([p]) for p in prompts]
        gp._run_batch(reqs)
    finally:
        gp.close()
    monkeypatch.undo()
    assert shapes == [(4, 16)]
    for r, ref in zip(reqs, refs):
        np.testing.assert_array_equal(r.result, ref)
    # the same three requests unpadded, on a fresh pool reserved alike
    cache = PagedKVCache(*tm._decode_cache_spec(), block_size=8,
                         num_blocks=16, dtype=gp.kv_cache.dtype, device="cpu")
    plens = np.asarray([len(p) for p in prompts])
    batch = np.zeros((3, 16), np.int64)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    nb = cache.blocks_for(16 + NEW)
    for i, p in enumerate(prompts):
        cache.reserve(i, len(p) + NEW)
    tables = np.stack([cache.block_table(i, pad_to=nb) for i in range(3)])
    toks = tm.generate_paged(batch, plens, cache, tables, max_new_tokens=NEW)
    for i, (p, ref) in enumerate(zip(prompts, refs)):
        np.testing.assert_array_equal(toks[i], ref[len(p):])
    nbk = cache.num_blocks                  # pages [Hkv, NB + 1, BS, D]
    for a, b in zip(gp.kv_cache.k_pages + gp.kv_cache.v_pages,
                    cache.k_pages + cache.v_pages):
        assert torch.equal(a[:, :nbk], b[:, :nbk])


@pytest.mark.parametrize("kind", ["whole_batch", "continuous"])
def test_signature_mismatch_degrades_to_dense_with_parity(small, kind):
    """The twin of test_signature_mismatch_degrades_to_dense_with_parity
    (tests/test_chaos_serving.py:415): a pool whose (layers, kv heads, head
    dim) differ from the model's serves through per-request dense
    generate() with JAX's tokens, and the pool is never touched. The
    continuous predictor hands such a pool to the same loop."""
    jm, tm = small
    prompt = np.random.default_rng(0).integers(0, 128, 5).astype("int64")
    ref = _jax_generate(jm, prompt[None], 3)[0]
    _assert_margins(tm, ref[None], 5)
    cache = PagedKVCache(2, 4, 16, block_size=8, num_blocks=16,
                         dtype=torch.float32, device="cpu")  # model: 2 heads
    if kind == "whole_batch":
        gp = GenerateBatchingPredictor(tm, max_batch_size=2, max_delay_ms=5,
                                       max_new_tokens=3, kv_cache=cache,
                                       device="cpu")
    else:
        gp = ContinuousGenerateBatchingPredictor(
            tm, max_slots=2, max_new_tokens=3, kv_cache=cache, device="cpu")
    try:
        assert gp.fallback_dense
        out = gp.infer(prompt, timeout=120)
        np.testing.assert_array_equal(out, ref)
        assert gp.metrics.get("dense_fallback_batches") == 1
        assert cache.blocks_in_use == 0
        assert all(bool((p == 0).all()) for p in cache.k_pages + cache.v_pages)
    finally:
        gp.close()


def _cut_probs(logits, temperature, top_k):
    scaled = np.asarray(logits, np.float64) / temperature
    kth = np.sort(scaled)[-top_k]
    scaled = np.where(scaled < kth, -np.inf, scaled)
    e = np.exp(scaled - scaled.max())
    return e / e.sum()


def _chi_square(counts, probs, n):
    support = probs > 0
    exp = probs[support] * n
    assert counts[~support].sum() == 0, "sampled outside the top-k support"
    return float(((counts[support] - exp) ** 2 / exp).sum())


def test_dense_sampler_first_token_law():
    """The twin of test_dense_fused_sampler_first_token_law
    (tests/test_speculative.py:307): the first sampled token of generate()
    follows the cut-softmax law of the target's logits (JAX's forward over
    the same weights). 400 draws as one batch of 400 identical prompts."""
    jm, tm = _pair(dict(vocab_size=24, hidden_size=32, num_layers=1,
                        num_heads=2, max_position=32), 5)
    T, TOPK, N = 0.9, 6, 400
    prompt = np.array([7, 3, 7, 3, 1, 0], np.int64)
    logits = np.asarray(jm(paddle.to_tensor(prompt[None]))._value)[0, -1]
    p0 = _cut_probs(logits, T, TOPK)
    out = tm.generate(np.tile(prompt, (N, 1)), max_new_tokens=1,
                      temperature=T, top_k=TOPK, seed=3, dtype=None)
    counts = np.bincount(out[:, -1].numpy(), minlength=24)
    # df 5; 25 is far out in the tail (p < 1e-3), yet a wrong temperature
    # or an uncut tail misses it by a mile
    assert _chi_square(counts, p0, N) < 25.0
