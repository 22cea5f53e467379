"""Speculative decoding of the PyTorch port — drafters, ``verify_step`` and
the single-stream loop — held against the JAX package and against the
port's own dense ``generate()``.

* greedy speculative output equals dense ``generate()``'s for every drafter
  (whose greedy tokens equal JAX's, after a top-1 / top-2 logit margin of
  1e-3 is asserted at every pick);
* one greedy ``verify_step`` gives JAX's (accepted, next) on the same
  weights, pool contents and chunk;
* ``SpecStats`` accounts drafted / accepted / launches / emitted tokens;
* the sampled path is distribution-exact: the first token out of
  ``verify_step`` (the accepted draft or the masked-residual resample)
  chi-square-matches the cut-softmax law of the target's logits (JAX's
  forward over the same weights), as tests/test_speculative.py:255 pins it
  for JAX.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.inference.kv_cache import PagedKVCache as JaxPagedKVCache
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.inference import PagedKVCache
from paddle_tpu_torch.inference.speculative import (
    DraftModelDrafter,
    NGramDrafter,
    SelfSpeculativeDrafter,
    SpecStats,
    make_drafter,
    speculative_generate,
)
from paddle_tpu_torch.models import gpt as tgpt

MARGIN = 1e-3


def _pair(cfg_kw, seed):
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg_kw))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    return jm, from_paddle_tpu_state(state, tgpt.GPTConfig(**cfg_kw),
                                     device="cpu")


@pytest.fixture(scope="module")
def small():
    """tests/test_speculative.py's ``small_gpt``, on both sides."""
    return _pair(dict(vocab_size=160, hidden_size=64, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_position=96), 11)


@pytest.fixture(scope="module")
def tiny_vocab():
    """A vocab of 24 so 400 draws resolve the whole law."""
    return _pair(dict(vocab_size=24, hidden_size=32, num_layers=1,
                      num_heads=2, max_position=32), 5)


@torch.no_grad()
def _dense(tm, prompt, n, eos=None):
    return tm.generate(np.asarray(prompt)[None], max_new_tokens=n,
                       dtype=None, eos_token_id=eos)[0].numpy()


@torch.no_grad()
def _assert_margins(tm, seq, P):
    lg = tm(torch.tensor(np.asarray(seq))[None]).float()[0, P - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    assert bool((gap > MARGIN).all()), f"near-tie: min margin {gap.min()}"


def _spec(tm, prompt, n, **kw):
    kw.setdefault("spec_k", 4)
    kw.setdefault("dtype", None)
    return np.asarray(speculative_generate(tm, np.asarray(prompt), n, **kw))


class ReplayDrafter:
    """Oracle: replays a recorded continuation (acceptance 1.0 against the
    chain it was recorded from)."""

    def __init__(self, plen, continuation):
        self.plen = plen
        self.cont = np.asarray(continuation, np.int64)

    def draft(self, history, k):
        pos = len(history) - self.plen
        return self.cont[pos:pos + int(k)]


# --------------------------------------------------------------- drafters
def test_ngram_drafter_matches_jax():
    d, jd = NGramDrafter(max_n=3, min_n=1), jspec.NGramDrafter(3, 1)
    h = np.array([7, 8, 9, 1, 7, 8, 9, 2, 9], np.int64)
    np.testing.assert_array_equal(d.draft(h, 2), [2, 9])
    h2 = np.array([7, 8, 9, 1, 5, 7, 8, 9], np.int64)
    np.testing.assert_array_equal(d.draft(h2, 3), [1, 5, 7])
    assert len(d.draft(np.array([1, 2, 3], np.int64), 4)) == 0
    assert len(d.draft(h, 0)) == 0
    rng = np.random.default_rng(0)
    for _ in range(50):
        hist = rng.integers(0, 6, rng.integers(1, 30))
        k = int(rng.integers(0, 5))
        np.testing.assert_array_equal(d.draft(hist, k), jd.draft(hist, k))
    for lo, hi in ((3, 2), (0, 1)):
        with pytest.raises(ValueError):
            NGramDrafter(max_n=hi, min_n=lo)


def test_make_drafter_resolution(small):
    _, tm = small
    assert isinstance(make_drafter("ngram"), NGramDrafter)
    assert isinstance(make_drafter(None), NGramDrafter)
    d = make_drafter("self", tm)
    assert isinstance(d, SelfSpeculativeDrafter)
    assert (d.model, d.dtype, d.decode_kernel) == (tm, "bfloat16", "kernel")
    # the loop's dtype and decode_kernel reach the self-drafter
    d = make_drafter("self", tm, dtype=None, decode_kernel="plain")
    assert (d.dtype, d.decode_kernel) == (None, "plain")
    d = NGramDrafter()
    assert make_drafter(d) is d
    for bad in (("self",), ("markov",), (object(),)):
        with pytest.raises(ValueError):
            make_drafter(*bad)


def test_draft_model_drafter_fixed_window(small):
    jm, tm = small
    d = DraftModelDrafter(tm, window=4, dtype=None)
    assert len(d.draft(np.array([1, 2, 3], np.int64), 4)) == 0
    h = np.arange(10, dtype=np.int64) % 160
    prop = d.draft(h, 3)
    ref = np.asarray(jm.generate(paddle.to_tensor(h[-4:][None]),
                                 max_new_tokens=3, dtype=None,
                                 decode_kernel="xla")._value)[0]
    _assert_margins(tm, ref, 4)
    np.testing.assert_array_equal(prop, ref[4:])
    np.testing.assert_array_equal(d.draft(h, 2), ref[4:6])


def test_self_drafter_runs_in_the_loops_dtype_and_kernel(small, monkeypatch):
    """speculative_generate(drafter='self') drafts through generate() with
    the loop's own dtype and decode_kernel."""
    _, tm = small
    seen = []
    real = tm.generate

    def spy(*a, **kw):
        seen.append((kw["dtype"], kw["decode_kernel"]))
        return real(*a, **kw)

    monkeypatch.setattr(tm, "generate", spy)
    prompt = np.arange(20, dtype=np.int64) % 160
    for dtype, kernel in ((None, "plain"), ("float32", "kernel")):
        seen.clear()
        _spec(tm, prompt, 6, drafter="self", dtype=dtype,
              decode_kernel=kernel)
        assert seen and set(seen) == {(dtype, kernel)}


# ------------------------------------------------- greedy identity vs dense
_PROMPTS = {
    "random": np.random.default_rng(3).integers(0, 160, 9).astype(np.int64),
    "repeating": np.tile(np.array([4, 17, 52], np.int64), 4)[:10],
}


@pytest.fixture(scope="module")
def jax_dense_refs(small):
    """JAX's dense greedy decode of each prompt, computed once before the
    tests (its scan compiles per shape: setup, not a test's call)."""
    jm, _ = small
    return {kind: np.asarray(jm.generate(
        paddle.to_tensor(prompt[None]), max_new_tokens=12, dtype=None,
        decode_kernel="xla")._value)[0] for kind, prompt in _PROMPTS.items()}


@pytest.mark.parametrize("kind", sorted(_PROMPTS))
def test_greedy_identity_vs_dense_all_drafters(small, jax_dense_refs, kind):
    _, tm = small
    prompt = _PROMPTS[kind]
    ref = _dense(tm, prompt, 12)
    _assert_margins(tm, ref, len(prompt))
    np.testing.assert_array_equal(ref, jax_dense_refs[kind])
    for drafter in ("ngram",
                    SelfSpeculativeDrafter(tm, window=4, dtype=None),
                    ReplayDrafter(len(prompt), ref[len(prompt):])):
        np.testing.assert_array_equal(_spec(tm, prompt, 12,
                                            drafter=drafter), ref)


def test_oracle_drafter_accepts_everything(small):
    _, tm = small
    prompt = np.arange(8, dtype=np.int64) * 3 % 160
    ref = _dense(tm, prompt, 15)
    st = SpecStats()
    got = _spec(tm, prompt, 15, drafter=ReplayDrafter(8, ref[8:]), stats=st)
    np.testing.assert_array_equal(got, ref)
    assert st.acceptance_rate == 1.0 and st.wasted == 0 and st.emitted == 15
    assert st.launches <= 1 + (15 + 4) // 5


def test_eos_freezes_the_remainder_like_dense(small):
    _, tm = small
    prompt = np.array([3, 1, 4, 1, 5, 9], np.int64)
    probe = _dense(tm, prompt, 10)
    eos = int(probe[6 + 3])
    ref = _dense(tm, prompt, 10, eos=eos)
    np.testing.assert_array_equal(_spec(tm, prompt, 10, eos_token_id=eos),
                                  ref)
    assert (ref[6 + 4:] == eos).all()


def test_batched_singleton_shape_and_batch_rejected(small):
    _, tm = small
    prompt = np.array([[5, 6, 7, 8]], np.int64)
    got = _spec(tm, prompt, 6)
    assert got.shape == (1, 10)
    np.testing.assert_array_equal(got[0], _dense(tm, prompt[0], 6))
    with pytest.raises(ValueError):
        _spec(tm, np.zeros((2, 4), np.int64), 6)
    with pytest.raises(ValueError):
        _spec(tm, prompt, 6, spec_k=0)


def test_spec_stats_accounting_consistent(small):
    _, tm = small
    st = SpecStats()
    out = _spec(tm, np.tile(np.array([9, 2], np.int64), 5), 14, stats=st)
    assert st.emitted == 14 == len(out) - 10
    assert 0 <= st.accepted <= st.drafted
    assert st.wasted == st.drafted - st.accepted
    # prefill emits one token, every verify call one more; accepts are the
    # rest (the tail call may overshoot max_new and truncate)
    assert 1 + st.launches + st.accepted >= st.emitted
    assert st.to_dict()["acceptance_rate"] == pytest.approx(
        st.acceptance_rate, abs=1e-4)


def test_sampled_speculative_stays_in_vocab_and_terminates(small):
    _, tm = small
    st = SpecStats()
    out = _spec(tm, np.array([11, 13, 17, 19], np.int64), 12,
                temperature=1.1, top_k=20, seed=123, stats=st)
    assert out.shape == (16,) and (out >= 0).all() and (out < 160).all()
    assert st.emitted == 12


# ----------------------------------------------------------- verify_step
def test_verify_step_matches_jax_greedy(small):
    """Two slots over the same prefilled pools: one whose drafts are the
    target's greedy chain (all accepted), one with a wrong second draft
    (one accepted, the next token the target's argmax there); an idle
    third slot holds its token and writes nothing."""
    jm, tm = small
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, 160, (3, 6)).astype(np.int64)
    chains = [_dense(tm, p, 5) for p in prompts]
    for p, c in zip(prompts, chains):
        _assert_margins(tm, c, 6)
    results = []
    for model, kv in ((jm, JaxPagedKVCache(*jm._decode_cache_spec(),
                                           block_size=8, num_blocks=8,
                                           dtype="float32")),
                      (tm, PagedKVCache(*tm._decode_cache_spec(),
                                        block_size=8, num_blocks=8,
                                        dtype=torch.float32, device="cpu"))):
        kw = dict(decode_kernel="xla") if model is jm else {}
        tables = np.stack([kv.reserve(i, 16) for i in range(3)])
        model.prefill_chunk(prompts, np.zeros(3, np.int64),
                            np.full(3, 6, np.int64), kv, tables, **kw)
        chunk = np.stack([c[6:10] for c in chains])    # cur + 3 drafts
        chunk[1, 2] = (chunk[1, 2] + 1) % 160          # slot 1: wrong 2nd
        acc, nxt = model.verify_step(
            chunk, np.full(3, 6, np.int64), np.full(3, 3, np.int64),
            np.array([True, True, False]), kv, tables,
            max_lens=np.full(3, 16, np.int64), **kw)
        results.append((np.asarray(getattr(acc, "_value", acc)),
                        np.asarray(getattr(nxt, "_value", nxt)), chunk))
        if model is tm:
            blk = tables[2, 0]
            assert all(bool((p[:, blk, 6:] == 0).all())
                       for p in kv.k_pages + kv.v_pages)
    (ja, jn, _), (ta, tn, chunk) = results
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(ta, [3, 1, 0])
    np.testing.assert_array_equal(tn, [chains[0][10], chains[1][8],
                                       chunk[2, 0]])


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


def test_verify_step_first_token_law_matches_target(tiny_vocab):
    """Over 400 slots verified in one call (independent draws), the first
    token after the verify (the accepted draft OR the masked-residual
    resample) follows the target's cut-softmax law: the accept / reject
    split is invisible in the marginal. The draft is chosen
    mid-probability so both paths fire."""
    jm, tm = tiny_vocab
    T, TOPK, N = 0.9, 6, 400
    prompt = np.array([1, 2, 3, 4, 5, 6], np.int64)
    kv = PagedKVCache(*tm._decode_cache_spec(), block_size=8, num_blocks=N,
                      dtype=torch.float32, device="cpu")
    tables = np.stack([kv.reserve(i, 8) for i in range(N)])
    tok = tm.prefill_chunk(np.tile(prompt, (N, 1)), np.zeros(N, np.int64),
                           np.full(N, 6, np.int64), kv, tables)
    c0 = int(tok[0])
    assert (tok == c0).all()
    seq = np.concatenate([prompt, [c0]])
    _assert_margins(tm, seq, 6)
    logits = np.asarray(jm(paddle.to_tensor(seq[None]))._value)[0, -1]
    p0 = _cut_probs(logits, T, TOPK)
    mid = int(np.argsort(p0)[-3])
    assert 0.05 < p0[mid] < 0.95
    acc, nxt = tm.verify_step(
        np.tile([[c0, mid]], (N, 1)), np.full(N, 6, np.int64),
        np.ones(N, np.int64), np.ones(N, bool), kv, tables,
        max_lens=np.full(N, 8, np.int64), temperature=T, top_k=TOPK, seed=0)
    first = np.where(acc == 1, mid, nxt)
    assert 0 < acc.sum() < N                 # both paths exercised
    counts = np.bincount(first, minlength=24)
    # df = 5; 25 is far out in the tail (p < 1e-3) yet still catches a
    # wrong law (e.g. an un-renormalised residual) by a mile
    assert _chi_square(counts, p0, N) < 25.0
