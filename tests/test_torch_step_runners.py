"""The step programs' runner cache of the PyTorch port (``jit/graphs.py``,
``models/generation.py``), on the CPU, held against the JAX package's
runner-cache pins and against itself.

On the CPU a runner runs the same body, on the same static buffers, that
CUDA captures into a graph, so these tests exercise the captured code:

* the fixed-length pool write (``paged_write_slots``) leaves the live pages
  bit-equal to the ``nonzero`` form and to JAX's ``paged_cache_update``
  (XLA's out-of-bounds drop) for idle slots, padding, rows at or past a
  write ceiling and rows past the table; dropped rows land only in the
  pool's scratch slot;
* twins of the JAX pins: mixed greedy / sampled traffic through the
  continuous scheduler makes exactly two step-program keys
  (``tests/test_continuous_serving.py:320-323``); the ngram, replay-all and
  self drafters and three sampled seeds share one ``verify_step`` key
  (``tests/test_speculative.py:226-233``); budgets 3 and 4 share one dense
  runner and budget 3 is budget 4 truncated
  (``tests/test_compile_surface.py:186-200``);
* two pools of one signature get separate runners, and each call writes
  only its own pool; a pool's runners go when the pool does;
* a second call at a key reports ``compiled: False`` and makes no key; the
  timing hook carries JAX's fields, ``flops`` when asked;
* one seed gives the same sampled tokens, another seed others;
* ``generate_paged`` runs one program per (B, P, n) key, a shorter budget
  the longer one's prefix, writes nothing live past its budget, and keeps
  the most recently used runners; the whole-batch predictor's prompts of
  one power-of-two width share a key.

Greedy tokens are compared only after a top-1 / top-2 logit margin of
1e-3 is asserted (f32 near-ties would make identity a coin flip).
"""
import gc
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu_torch.inference import (
    ContinuousGenerateBatchingPredictor,
    PagedKVCache,
)
from paddle_tpu_torch.inference.speculative import (
    SelfSpeculativeDrafter,
    speculative_generate,
)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import paged_attention as tpa

MARGIN = 1e-3
SMALL = dict(vocab_size=160, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_position=96)


@pytest.fixture(scope="module")
def model():
    return tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL), device="cpu",
                               seed=11)


def _fresh():
    return tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL), device="cpu",
                               seed=11)


def _cache(m, num_blocks=16, block_size=8):
    return PagedKVCache(*m._decode_cache_spec(), block_size=block_size,
                        num_blocks=num_blocks, dtype=torch.float32,
                        device="cpu")


def _keys(m, *kinds):
    return [k for k in m._generate_cache if k[0] in kinds]


@torch.no_grad()
def _assert_margins(m, seq, P):
    lg = m(torch.as_tensor(np.asarray(seq))[None]).float()[0, P - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    assert bool((gap > MARGIN).all()), f"near-tie: min margin {gap.min()}"


# ------------------------------------------------- the fixed-length write
_WRITES = {
    # lengths, valid [B, S]: idle slot 2, padding in slot 0
    "idle_and_padding": ([6, 20, 0], [[1, 1, 1, 0], [1, 1, 1, 1],
                                      [0, 0, 0, 0]]),
    # slot 1 reaches past NB*BS = 24: rows 24.. have no page
    "past_the_table": ([6, 22, 3], [[1, 1, 1, 1], [1, 1, 1, 1],
                                    [1, 1, 0, 0]]),
    # a write ceiling: rows at or past max_lens are not valid
    "at_the_ceiling": ([5, 9, 14], [[1, 1, 0, 0], [1, 0, 0, 0],
                                    [1, 1, 1, 0]]),
}


@pytest.mark.parametrize("case", sorted(_WRITES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fixed_length_write_matches_nonzero_form_and_jax(case, dtype):
    rng = np.random.default_rng(3)
    B, S, Hkv, D, BS, NB, nblocks = 3, 4, 2, 16, 8, 3, 10
    lengths, valid = (np.asarray(a) for a in _WRITES[case])
    valid = valid.astype(bool)
    tables = np.array([[4, 1, 0], [7, 2, 9], [3, 5, 0]], np.int32)
    kp = rng.standard_normal((Hkv, nblocks + 1, BS, D)).astype(np.float32)
    kn = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    td = getattr(torch, dtype)
    scratch = nblocks * BS
    pos = lengths[:, None] + np.arange(S)[None, :]

    fixed = torch.tensor(kp).to(td)
    slots = tpa.paged_write_slots(torch.from_numpy(tables),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(valid), BS, scratch)
    assert slots.shape == (B * S,)
    tpa.paged_scatter_(fixed, torch.from_numpy(kn), None, slots)

    nz = torch.tensor(kp).to(td)
    wpos = tpa.write_positions(torch.from_numpy(lengths), S,
                               valid=torch.from_numpy(valid),
                               capacity=NB * BS)
    rows, nz_slots = tpa.paged_write_index(torch.from_numpy(tables), wpos,
                                           BS)
    tpa.paged_scatter_(nz, torch.from_numpy(kn), rows, nz_slots)
    assert len(rows) < B * S                     # some rows were dropped
    torch.testing.assert_close(fixed[:, :nblocks], nz[:, :nblocks], atol=0,
                               rtol=0)

    jd = getattr(jnp, dtype)
    rk, _ = jda.paged_cache_update(
        jnp.asarray(kp[:, :nblocks]).astype(jd),
        jnp.asarray(kp[:, :nblocks]).astype(jd), jnp.asarray(kn),
        jnp.asarray(kn), jnp.asarray(tables), jnp.asarray(wpos.numpy()))
    np.testing.assert_array_equal(fixed[:, :nblocks].float().numpy(),
                                  np.asarray(rk.astype(jnp.float32)))
    # dropped rows went to the scratch slot, and nowhere else
    dropped = (slots == scratch).nonzero()[:, 0]
    assert len(dropped) == B * S - len(rows)
    untouched = torch.tensor(kp).to(td)[:, nblocks]
    assert not torch.equal(fixed[:, nblocks, 0], untouched[:, 0])
    torch.testing.assert_close(fixed[:, nblocks, 1:], untouched[:, 1:],
                               atol=0, rtol=0)


def test_pool_has_a_scratch_page_no_table_names():
    kv = PagedKVCache(2, 2, 8, block_size=4, num_blocks=5,
                      dtype=torch.float32, device="cpu")
    assert kv.k_pages[0].shape == (2, 6, 4, 8)   # num_blocks + 1 pages
    assert kv.scratch_slot == 5 * 4
    assert kv.signature() == (2, 2, 8, 4, 5, "torch.float32")
    tables = [kv.reserve(i, 4) for i in range(5)]
    assert sorted(int(t[0]) for t in tables) == list(range(5))


# ----------------------------------------------------- the JAX pins' twins
def test_mixed_samplers_make_two_step_programs():
    """The twin of tests/test_continuous_serving.py:320-323: greedy and
    sampled requests through one continuous scheduler fork no step
    program, and the greedy ones get dense generate()'s tokens."""
    m = _fresh()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 160, n).astype(np.int64)
               for n in (3, 5, 7, 4, 6, 9)]
    refs = [m.generate(p[None], 6, dtype=None)[0].numpy() for p in prompts]
    samplers = [dict(), dict(temperature=0.8, top_k=5),
                dict(temperature=1.2), dict(),
                dict(temperature=0.5, top_k=3),
                dict(temperature=0.9, top_k=1)]
    gp = ContinuousGenerateBatchingPredictor(
        m, max_slots=3, prefill_chunk=4, decode_steps=2, max_new_tokens=6,
        max_seq_len=24, kv_cache=_cache(m, num_blocks=12), device="cpu")
    outs = [None] * len(prompts)

    def client(i):
        outs[i] = gp.infer(prompts[i], timeout=120, **samplers[i])

    try:
        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(prompts))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        gp.close()
    for i, out in enumerate(outs):
        assert out is not None and out.shape == (len(prompts[i]) + 6,)
        np.testing.assert_array_equal(out[:len(prompts[i])], prompts[i])
        assert (out >= 0).all() and (out < 160).all()
        if not samplers[i]:
            _assert_margins(m, refs[i], len(prompts[i]))
            np.testing.assert_array_equal(out, refs[i])
    step_keys = [k for k in _keys(m, "prefill_chunk", "decode_step")
                 if k[5] == -1]
    assert len(step_keys) == 2, step_keys


class _Replay:
    def __init__(self, plen, cont):
        self.plen, self.cont = plen, np.asarray(cont, np.int64)

    def draft(self, history, k):
        pos = len(history) - self.plen
        return self.cont[pos:pos + int(k)]


def test_one_verify_program_across_drafters_and_seeds():
    """The twin of tests/test_speculative.py:226-233: drafters of every
    quality, temperatures and seeds ride one verify_step program and one
    prefill program; the loop's private pool is lent from call to call."""
    m = _fresh()
    prompt = np.random.default_rng(7).integers(0, 160, 8).astype(np.int64)
    ref = m.generate(prompt[None], 10, dtype=None)[0].numpy()

    def spec(**kw):
        return speculative_generate(m, prompt, 10, spec_k=4, dtype=None,
                                    **kw)

    spec()
    spec(drafter=_Replay(8, ref[8:]))
    spec(drafter=SelfSpeculativeDrafter(m, window=4, dtype=None))
    for seed in (1, 2, 3):
        spec(temperature=0.8, top_k=12, seed=seed)
    assert len(_keys(m, "verify_step")) == 1, _keys(m, "verify_step")
    pre = [k for k in _keys(m, "prefill_chunk") if k[1:3] == (1, 8)]
    assert len(pre) == 1, pre


def test_dense_budgets_share_one_runner_token_exact():
    """The twin of tests/test_compile_surface.py:186-200."""
    m = _fresh()
    prompt = np.arange(1, 9, dtype=np.int64)[None]
    o3 = m.generate(prompt, 3, dtype=None)
    o4 = m.generate(prompt, 4, dtype=None)
    assert o3.shape == (1, 11) and o4.shape == (1, 12)
    assert torch.equal(o3, o4[:, :11])
    run = m.compiled_generate_runner(1, 8, 3)
    assert run is not None and run is m.compiled_generate_runner(1, 8, 4)
    assert m.compiled_generate_runner(1, 8, 5) is None
    assert len(_keys(m, "dense")) == 1


def test_dense_runners_keep_the_most_recent():
    from paddle_tpu_torch.models import generation as tgen

    m = _fresh()
    for P in range(1, tgen._DENSE_RUNNERS + 3):
        m.generate(np.arange(P, dtype=np.int64)[None], 2, dtype=None)
    kept = sorted(k[2] for k in _keys(m, "dense"))
    assert kept == list(range(3, tgen._DENSE_RUNNERS + 3))


# ------------------------------------------------------ pools and keys
def test_two_pools_of_one_signature_get_separate_runners(model):
    """Same signature, two pools: two runners, and each call writes only
    its own pool's live pages (the other's stay zero)."""
    m = model
    a, b = _cache(m, num_blocks=6), _cache(m, num_blocks=6)
    assert a.signature() == b.signature() and a.uid != b.uid
    ids = np.random.default_rng(1).integers(0, 160, (2, 5))
    for kv in (a, b):
        tables = np.stack([kv.reserve(i, 12) for i in range(2)])
        m.prefill_chunk(ids, np.zeros(2, np.int64), np.full(2, 5), kv, tables)
        other = b if kv is a else a
        assert all(bool((p[:, :6] == 0).all())
                   for p in other.k_pages + other.v_pages) == (kv is a)
        assert any(bool((p[:, :6] != 0).any()) for p in kv.k_pages)
    pre = [k for k in _keys(m, "prefill_chunk") if k[1:3] == (2, 5)]
    assert len({k[8] for k in pre}) >= 2
    assert {("pool", a.uid), ("pool", b.uid)} <= {k[8] for k in pre}


def test_a_dead_pool_drops_its_runners():
    m = _fresh()
    kv = _cache(m, num_blocks=4)
    tables = kv.reserve(0, 8)[None]
    m.decode_step(np.array([3]), np.array([0]), np.array([True]), kv,
                  tables, steps=2)
    assert len(_keys(m, "decode_step")) == 1
    del kv
    gc.collect()
    assert _keys(m, "decode_step") == []


def _call(m, kind, kv, tables, seed=0, **kw):
    S = tables.shape[0]
    if kind == "prefill_chunk":
        return m.prefill_chunk(np.arange(S * 4).reshape(S, 4) % 160,
                               np.zeros(S, np.int64), np.full(S, 4), kv,
                               tables, seed=seed, **kw)
    if kind == "decode_step":
        return m.decode_step(np.arange(S), np.full(S, 4), np.ones(S, bool),
                             kv, tables, steps=3, seed=seed, **kw)
    return m.verify_step(np.arange(S * 3).reshape(S, 3) % 160,
                         np.full(S, 4), np.full(S, 2), np.ones(S, bool), kv,
                         tables, seed=seed, **kw)


_SHAPES = {"prefill_chunk": (2, 4, 0), "decode_step": (2, 1, 3),
           "verify_step": (2, 3, 1)}


@pytest.mark.parametrize("kind", sorted(_SHAPES))
def test_second_call_is_not_compiled_and_makes_no_key(kind):
    """JAX's timing_hook fields; ``compiled`` True only on the call that
    built the program; ``flops`` only when the hook asks, the same count
    each call."""
    m = _fresh()
    kv = _cache(m)
    tables = np.stack([kv.reserve(i, 16) for i in range(2)])
    seen = []
    hook = seen.append
    _call(m, kind, kv, tables, timing_hook=hook)
    keys = list(m._generate_cache)

    class Wants(list):
        wants_flops = True

        def __call__(self, rec):
            self.append(rec)

    wants = Wants()
    for _ in range(2):
        _call(m, kind, kv, tables, timing_hook=wants)
    assert list(m._generate_cache) == keys and len(keys) == 1
    assert keys[0][0] == kind
    for rec in seen + wants:
        assert (rec["path"], rec["batch"], rec["prompt_len"],
                rec["new_tokens"]) == (kind, *_SHAPES[kind])
        assert rec["launch_s"] > 0
        assert rec["per_token_s"] == rec["launch_s"] / max(
            1, rec["new_tokens"])
    assert [r["compiled"] for r in seen + wants] == [True, False, False]
    assert seen[0]["flops"] is None
    assert wants[0]["flops"] == wants[1]["flops"] > 0
    getter = getattr(m, f"compiled_{kind}_runner")
    assert getter(2, _SHAPES[kind][2 if kind == "decode_step" else 1]
                  ) is m._generate_cache[keys[0]]


def test_prefill_flops_count_the_aten_products(model):
    """On the CPU the count covers every product: the linears, the LM
    head and the plain attention's two einsums over the gathered cache."""
    m = _fresh()
    kv = _cache(m)
    tables = np.stack([kv.reserve(i, 16) for i in range(2)])

    class Hook(list):
        wants_flops = True

        def __call__(self, rec):
            self.append(rec)

    hook = Hook()
    _call(m, "prefill_chunk", kv, tables, timing_hook=hook)
    c = m.config
    S, C, H, V = 2, 4, c.hidden_size, c.vocab_size
    Hkv = c.num_kv_heads
    D = H // c.num_heads
    tokens = S * C
    cols = tables.shape[1] * kv.block_size
    per_layer = 2 * tokens * (H * (H + 2 * Hkv * D) + H * H
                              + 3 * H * c.intermediate_size)
    attention = 2 * 2 * tokens * c.num_heads * D * cols
    want = c.num_layers * (per_layer + attention) + 2 * tokens * H * V
    assert hook[0]["flops"] == want


@pytest.mark.parametrize("kind", ["decode_step", "generate"])
def test_same_seed_same_draws_other_seed_others(model, kind):
    m = model
    kv = _cache(m)
    tables = np.stack([kv.reserve(("s", i), 16) for i in range(2)])

    def draw(seed):
        if kind == "generate":
            return m.generate(np.arange(10, dtype=np.int64).reshape(2, 5),
                              8, temperature=1.5, seed=seed,
                              dtype=None).numpy()
        return _call(m, "decode_step", kv, tables, seed=seed,
                     temperature=1.5)

    first, again, other = draw(4), draw(4), draw(5)
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(first, other)


def test_generate_paged_runs_one_program_per_key():
    """generate_paged through its runner: budgets 3 and 4 key
    ("paged", B, P, n, ...) apart and budget 3 is budget 4 truncated; the
    tokens are dense generate()'s per request; budget 3 writes no row past
    its budget; a second call at a key replays it; the timing hook carries
    JAX's fields (path "paged", compiled on the building call only);
    compiled_generate_paged_runner returns the key's runner."""
    m = _fresh()
    kv = _cache(m, num_blocks=16, block_size=4)
    plens = np.array([7, 4])
    rng = np.random.default_rng(3)
    ids = np.zeros((2, 7), np.int64)
    for b, n in enumerate(plens):
        ids[b, :n] = rng.integers(0, 160, n)
    tables = np.stack([kv.reserve(b, 7 + 4) for b in range(2)])
    seen = []
    o3 = m.generate_paged(ids, plens, kv, tables, max_new_tokens=3,
                          timing_hook=seen.append)
    live = [p[:, :kv.num_blocks].clone() for p in kv.k_pages]
    # budget 3 ran 2 decode forwards: row plen + 2 was never written
    for b, n in enumerate(plens):
        page, row = tables[b, (n + 2) // 4], (n + 2) % 4
        assert all(bool((p[:, page, row] == 0).all()) for p in live)
    o4 = m.generate_paged(ids, plens, kv, tables, max_new_tokens=4,
                          timing_hook=seen.append)
    again = m.generate_paged(ids, plens, kv, tables, max_new_tokens=4,
                             timing_hook=seen.append)
    assert o3.shape == (2, 3) and o4.shape == (2, 4)
    np.testing.assert_array_equal(o4, again)
    np.testing.assert_array_equal(o3, o4[:, :3])
    for b, n in enumerate(plens):
        ref = m.generate(ids[b:b + 1, :n], 4, dtype=None)[0].numpy()
        _assert_margins(m, ref, n)
        np.testing.assert_array_equal(o4[b], ref[n:])
    keys = sorted(_keys(m, "paged"), key=lambda k: k[3])
    assert [k[:5] for k in keys] == [("paged", 2, 7, 3, 3),
                                     ("paged", 2, 7, 4, 3)]
    assert [(r["path"], r["batch"], r["prompt_len"], r["new_tokens"],
             r["compiled"]) for r in seen] == [("paged", 2, 7, 3, True),
                                               ("paged", 2, 7, 4, True),
                                               ("paged", 2, 7, 4, False)]
    for n, key in zip((3, 4), keys):
        assert m.compiled_generate_paged_runner(2, 7, n) is \
            m._generate_cache[key]
    assert m.compiled_generate_paged_runner(2, 7, 5) is None


def test_generate_paged_keeps_the_most_recent_runners(monkeypatch):
    from paddle_tpu_torch.models import generation as tgen

    monkeypatch.setattr(tgen, "_PAGED_RUNNERS", 2)
    m = _fresh()
    kv = _cache(m, num_blocks=16, block_size=4)
    tables = kv.reserve(0, 8 + 2)[None]
    for P in (3, 5, 8, 3):
        m.generate_paged(np.arange(P, dtype=np.int64)[None], [P], kv,
                         tables, max_new_tokens=2)
    assert sorted(k[2] for k in _keys(m, "paged")) == [3, 8]


def test_whole_batch_prompts_share_a_power_of_two_key():
    """The whole-batch predictor pads its prompts to a power of two: 5 and
    7 tokens share the P = 8 key, 9 tokens make P = 16; the tokens are
    dense generate()'s of each prompt alone."""
    from paddle_tpu_torch.inference import GenerateBatchingPredictor

    m = _fresh()
    gp = GenerateBatchingPredictor(m, max_batch_size=1, max_new_tokens=3,
                                   kv_cache=_cache(m), device="cpu")
    rng = np.random.default_rng(8)
    try:
        for n in (5, 7, 9):
            ids = rng.integers(0, 160, n).astype(np.int64)
            out = gp.infer(ids, timeout=60)
            ref = m.generate(ids[None], 3, dtype=None)[0].numpy()
            _assert_margins(m, ref, n)
            np.testing.assert_array_equal(out, ref)
    finally:
        gp.close()
    assert sorted(k[2] for k in _keys(m, "paged")) == [8, 16]
