"""The port's prefix cache (``inference/prefix_cache.py``), the pool's
refcounts and park tier (``inference/kv_cache.py``) and token streaming,
held against the JAX package (``tests/test_prefix_cache.py``).

* host level — the same operations on the JAX ``PrefixCache`` /
  ``PagedKVCache`` and on the port's give the same chain digests byte for
  byte, the same tables, lengths, refcounts, parked and indexed sets and
  ``check_conservation()`` dicts after every step, and fail the same way;
* model level — greedy requests through the port's continuous scheduler
  with ``prefix_cache=True`` give the JAX scheduler's tokens, cold and
  warm (``decode_kernel="xla"`` on the JAX side, f32 pools on both),
  after a top-1 / top-2 logit margin of 1e-3 is asserted; a warm request
  skips the shared blocks and is bit-identical to the cold one, greedy,
  sampled and speculative;
* wire level — ``infer_stream`` chunks and the /generate SSE events
  concatenate to the buffered answer; an abandoned stream cancels its
  sequence.
"""
import io
import itertools
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.kv_cache import CacheOutOfBlocks as JaxOutOfBlocks
from paddle_tpu.inference.kv_cache import PagedKVCache as JaxPagedKVCache
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxPrefixCache
from paddle_tpu.inference.scheduler import (
    ContinuousGenerateBatchingPredictor as JaxContinuous,
)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.inference import (
    ContinuousGenerateBatchingPredictor,
    GenerateBatchingPredictor,
    InferenceServer,
    PagedKVCache,
)
from paddle_tpu_torch.inference.kv_cache import CacheOutOfBlocks
from paddle_tpu_torch.inference.prefix_cache import PrefixCache
from paddle_tpu_torch.models import gpt as tgpt

MARGIN = 1e-3
SMALL = dict(vocab_size=160, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_position=96)
KNOBS = dict(max_slots=4, prefill_chunk=4, decode_steps=2, max_new_tokens=6,
             max_seq_len=40)


# ---------------------------------------------------------------- host level
def _pair(num_blocks=16, block_size=4):
    jkv = JaxPagedKVCache(1, 2, 8, block_size=block_size,
                          num_blocks=num_blocks, dtype="float32")
    tkv = PagedKVCache(1, 2, 8, block_size=block_size, num_blocks=num_blocks,
                       dtype=torch.float32, device="cpu")
    return [(jkv, JaxPrefixCache(jkv)), (tkv, PrefixCache(tkv))]


def _state(kv, px):
    """Everything the two sides must agree on, as plain Python."""
    parked, indexed = px._tier_snapshot()
    return dict(conservation=kv.check_conservation(),
                refs=dict(sorted(kv._block_refs.items())),
                tables={str(r): [int(b) for b in q.blocks]
                        for r, q in kv._requests.items()},
                lengths={str(r): int(q.length)
                         for r, q in kv._requests.items()},
                parked=sorted(parked), indexed=sorted(indexed),
                free=list(kv.allocator._free),
                evictable=kv.evictable_blocks,
                shared=kv.shared_block_count,
                evictions=(kv.evictions, kv.evicted_blocks,
                           px.evicted_blocks_total),
                hits=(px.hits, px.misses))


def _commit(kv, px, rid, tokens):
    kv.reserve(rid, len(tokens))
    kv.append_tokens(rid, len(tokens))
    px.register(rid, np.asarray(tokens, np.int64))


def _scenario_tail_cap(kv, px, out):
    toks = np.arange(10, dtype=np.int64)
    _commit(kv, px, "a", toks)
    kv.release("a")
    out.append(len(px.lookup(toks).pairs))
    fork = toks.copy()
    fork[5] = 99
    out.append(len(px.lookup(fork).pairs))
    out.append(len(px.lookup(fork + 100).pairs))
    out.append(len(px.lookup(np.arange(8, dtype=np.int64)).pairs))


def _scenario_shared(kv, px, out):
    toks = np.arange(12, dtype=np.int64)
    _commit(kv, px, "donor", toks)
    kv.release("donor")
    out.append(_state(kv, px))
    for rid, tail in (("r1", [1, 2, 3]), ("r2", [7, 8, 9])):
        hit = px.lookup(np.concatenate([toks, tail]))
        out.append(kv.reserve(rid, 15, shared=hit.pairs).tolist())
        out.append(kv.length(rid))
        out.append(_state(kv, px))
    for rid in ("r1", "r2"):
        kv.release(rid)
        out.append(_state(kv, px))


def _scenario_lru(kv, px, out):
    old = np.arange(8, dtype=np.int64)
    new = np.arange(100, 108, dtype=np.int64)
    _commit(kv, px, "old", old)
    kv.release("old")
    _commit(kv, px, "new", new)
    kv.release("new")
    px.lookup(old)
    out.append(kv.reserve("big", 24).tolist())
    out.append(_state(kv, px))
    out.append((len(px.lookup(old).pairs), len(px.lookup(new).pairs)))
    kv.release("big")
    out.append(_state(kv, px))


def _scenario_failed_reserve(kv, px, out):
    toks = np.arange(8, dtype=np.int64)
    _commit(kv, px, "donor", toks)
    kv.release("donor")
    kv.reserve("pin", 16)
    before = _state(kv, px)
    hit = px.lookup(np.concatenate([toks, [1]]))
    try:
        kv.reserve("huge", 36, shared=hit.pairs)
        out.append("reserved")
    except (CacheOutOfBlocks, JaxOutOfBlocks):
        out.append("out of blocks")
    after = _state(kv, px)
    before.pop("hits"), after.pop("hits")
    out.append(after == before)
    out.append(after)


def _scenario_purge_and_stale(kv, px, out):
    toks = np.arange(8, dtype=np.int64)
    _commit(kv, px, "donor", toks)
    kv.release("donor")
    hit = px.lookup(np.concatenate([toks, [1]]))
    out.append(px.purge())
    kv.reserve("r", 12, shared=hit.pairs)
    out.append(kv.length("r"))
    kv.release("r")
    out.append(_state(kv, px))


def _scenario_done_retained(kv, px, out):
    """Finished-but-retained holders are evicted before the parked tier,
    counting only the blocks that actually came home."""
    toks = np.arange(12, dtype=np.int64)
    _commit(kv, px, "a", toks)
    hit = px.lookup(np.concatenate([toks, [5]]))
    kv.reserve("b", 16, shared=hit.pairs)
    kv.mark_done("a")
    out.append(_state(kv, px))
    kv.reserve("c", 40)
    out.append(_state(kv, px))
    for rid in ("b", "c"):
        kv.mark_done(rid)
        kv.release(rid)
    out.append(_state(kv, px))


SCENARIOS = {"tail_cap": _scenario_tail_cap, "shared": _scenario_shared,
             "lru": _scenario_lru, "failed_reserve": _scenario_failed_reserve,
             "purge_and_stale": _scenario_purge_and_stale,
             "done_retained": _scenario_done_retained}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pool_and_index_match_jax(name):
    traces = []
    for kv, px in _pair(num_blocks=16 if name != "lru" and name !=
                        "failed_reserve" else 8):
        out = []
        SCENARIOS[name](kv, px, out)
        out.append(_state(kv, px))
        traces.append(out)
    assert traces[1] == traces[0]


@pytest.mark.parametrize("seed", [b"", b"adapter-7"])
@pytest.mark.parametrize("block_size", [4, 32])
def test_chain_digests_equal_jax_byte_for_byte(seed, block_size):
    toks = np.random.default_rng(block_size).integers(0, 50304, 200)
    (_, jpx), (_, tpx) = _pair(block_size=block_size)
    got = tpx.hash_blocks(toks, seed=seed)
    assert got == jpx.hash_blocks(toks, seed=seed)
    assert len(got) == 200 // block_size
    assert all(isinstance(d, bytes) and len(d) == 16 for d in got)


@pytest.mark.parametrize("seed", range(3))
def test_random_operation_sequences_match_jax(seed):
    """Seeded random reserve (with and without a prefix hit) / append /
    register / mark_done / release / purge sequences, eviction included:
    both sides agree after every operation, or run dry together."""
    rng = np.random.default_rng(seed)
    sides = _pair(num_blocks=24, block_size=4)
    vocab = np.arange(3)
    stems = [rng.choice(vocab, 8) for _ in range(2)]  # prefixes that recur
    live, done, n = [], [], itertools.count()
    seen_shared = False
    for _ in range(80):
        # reserve with a lookup / without, mark done, release, purge
        op = rng.choice(5, p=[0.45, 0.1, 0.15, 0.25, 0.05])
        outs = []
        if op <= 1 or not (live or done):
            rid = f"r{next(n)}"
            toks = np.concatenate([
                stems[int(rng.integers(len(stems)))][:int(rng.integers(9))],
                rng.choice(vocab, int(rng.integers(2, 12)))])
            for kv, px in sides:
                hit = px.lookup(toks) if op == 0 else None
                try:
                    kv.reserve(rid, len(toks) + 4,
                               shared=None if hit is None else hit.pairs)
                    kv.append_tokens(rid, len(toks) - kv.length(rid))
                    px.register(rid, toks)
                    outs.append(kv.length(rid))
                except (CacheOutOfBlocks, JaxOutOfBlocks):
                    outs.append("dry")
            if outs[0] != "dry":
                live.append(rid)
        elif op == 2 and live:
            rid = live.pop(int(rng.integers(len(live))))
            for kv, _ in sides:
                kv.mark_done(rid)
            done.append(rid)
        elif op == 3:
            pool = done if done and (not live or rng.random() < 0.5) \
                else live
            rid = pool.pop(int(rng.integers(len(pool))))
            for kv, _ in sides:     # a done request may have been evicted
                outs.append(rid in kv._requests)
                if outs[-1]:
                    kv.release(rid)
        else:
            outs = [px.purge() for _, px in sides]
        assert outs[1:] == outs[:1]
        st = _state(*sides[1])
        assert st == _state(*sides[0])
        seen_shared |= st["shared"] > 0
    kv = sides[1][0]
    assert seen_shared and kv.evictions > 0 and kv._prefix.hits > 0


def test_concurrent_sharing_conserves_the_pool():
    """16 threads (more than the cores) admit, share, register and release
    over one pool and index with a 1 µs switch interval, while a reader
    audits: every audit passes, and at the end every block is free or
    parked with its index entry."""
    import sys
    import threading

    kv, px = _pair(num_blocks=24, block_size=4)[1]
    stems = [np.arange(8, dtype=np.int64), np.arange(50, 58,
                                                     dtype=np.int64)]
    errors, stop = [], threading.Event()

    def worker(w):
        rng = np.random.default_rng(w)
        try:
            for i in range(40):
                toks = np.concatenate([stems[int(rng.integers(2))],
                                       rng.integers(0, 3, 5)])
                rid = (w, i)
                try:
                    kv.reserve(rid, len(toks) + 4,
                               shared=px.lookup(toks).pairs)
                except CacheOutOfBlocks:
                    continue
                kv.append_tokens(rid, len(toks) - kv.length(rid))
                px.register(rid, toks)
                if rng.random() < 0.5:
                    kv.mark_done(rid)
                    try:            # done: another admission may evict it
                        kv.release(rid)
                    except KeyError:
                        pass
                else:
                    kv.release(rid)
        except Exception as e:       # reported below, fails the test
            errors.append(repr(e))

    def auditor():
        while not stop.is_set():
            try:
                kv.check_conservation()
            except AssertionError as e:
                errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        audit = threading.Thread(target=auditor)
        audit.start()
        ts = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        stop.set()
        audit.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts + [audit])
    assert errors == []
    st = kv.check_conservation()
    assert st["requests"] == 0 and kv.blocks_in_use == px.cached_blocks()
    assert px.hits > 0


def test_scratch_page_stays_outside_every_count():
    kv, px = _pair(num_blocks=4, block_size=4)[1]
    _commit(kv, px, "a", np.arange(16, dtype=np.int64))
    kv.release("a")
    assert px.indexed_blocks() == 4 and kv.num_blocks not in px._by_block
    assert kv.k_pages[0].shape[1] == kv.num_blocks + 1
    assert kv.check_conservation()["free"] + kv.blocks_in_use == 4


def test_attaching_a_second_index_raises():
    kv, _ = _pair()[1]
    with pytest.raises(ValueError):
        PrefixCache(kv)
    with pytest.raises(NotImplementedError, match="A7"):
        PrefixCache(PagedKVCache(1, 2, 8, device="cpu"), faults=object())


# --------------------------------------------------------------- model level
@pytest.fixture(scope="module")
def pair():
    with paddle.utils.unique_name.guard():
        paddle.seed(11)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**SMALL))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    tm = from_paddle_tpu_state(state, tgpt.GPTConfig(**SMALL), device="cpu")
    return jm, tm


def _multi_turn_prompts():
    rng = np.random.default_rng(29)
    return (rng.integers(0, 160, 11).astype(np.int64),
            rng.integers(0, 160, 3).astype(np.int64))


def _prompt(seed, n=13):
    return np.random.default_rng(seed).integers(0, 160, n).astype(np.int64)


def _spec_prompt():
    rng = np.random.default_rng(37)
    return np.tile(rng.integers(0, 160, 5), 3)[:13].astype(np.int64)


@pytest.fixture(scope="module")
def jax_refs(pair):
    """The JAX scheduler's answers, computed once for the module."""
    jm = pair[0]
    refs = {}
    refs["hit"] = _serve(_jax(jm, prefix_cache=True), [_prompt(23)] * 2)
    gp = _jax(jm, prefix_cache=True)
    try:
        p1, extra = _multi_turn_prompts()
        o1 = np.asarray(gp.infer(p1, timeout=120))
        o2 = np.asarray(gp.infer(np.concatenate([o1, extra]), timeout=120))
        refs["chat"] = (o1, o2, gp.metrics.get("prefix_hit_tokens"))
    finally:
        gp.close()
    refs["spec"] = _serve(_jax(jm, prefix_cache=True, spec_k=2),
                          [_spec_prompt()] * 2)
    refs["stream"] = _serve(_jax(jm), [_prompt(53, 7)])[0]
    return refs


def _jax(jm, **kw):
    kv = JaxPagedKVCache(*jm._decode_cache_spec(), block_size=8,
                         num_blocks=32, dtype="float32")
    return JaxContinuous(jm, kv_cache=kv, decode_kernel="xla",
                         **{**KNOBS, **kw})


def _port(tm, block_size=8, **kw):
    kv = PagedKVCache(*tm._decode_cache_spec(), block_size=block_size,
                      num_blocks=32, dtype=torch.float32, device="cpu")
    kw.setdefault("prefix_cache", True)
    return ContinuousGenerateBatchingPredictor(tm, kv_cache=kv, device="cpu",
                                               **{**KNOBS, **kw})


@torch.no_grad()
def _assert_margins(tm, seq, plen):
    lg = tm(torch.as_tensor(np.asarray(seq))[None]).float()[0, plen - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    assert bool((gap > MARGIN).all()), f"near-tie: min margin {gap.min()}"


def _serve(gp, prompts, **kw):
    try:
        return [np.asarray(gp.infer(p, timeout=120, **kw)) for p in prompts]
    finally:
        gp.close()


def test_prefix_hit_greedy_matches_jax_cold_and_warm(pair, jax_refs):
    tm = pair[1]
    prompt = _prompt(23)
    ref = jax_refs["hit"]
    gp = _port(tm)
    cold = np.asarray(gp.infer(prompt, timeout=120))
    assert gp.metrics.get("prefix_hit_tokens") == 0
    warm = np.asarray(gp.infer(prompt, timeout=120))
    try:
        assert gp.metrics.get("prefix_hit_tokens") == 8     # (13-1)//8 blocks
        assert gp.kv_cache.blocks_in_use == gp.prefix_cache.cached_blocks()
        gp.kv_cache.check_conservation()
    finally:
        gp.close()
    _assert_margins(tm, cold, len(prompt))
    for got, want in zip((cold, warm), ref):
        np.testing.assert_array_equal(got, want)


def test_multi_turn_chat_hits_blocks_registered_at_retirement(pair,
                                                              jax_refs):
    """Turn 2 = turn 1's whole output + new tokens: the hit covers a block
    of GENERATED rows (registered at retirement), as in JAX."""
    tm = pair[1]
    p1, extra = _multi_turn_prompts()
    gp = _port(tm)
    try:
        t1 = np.asarray(gp.infer(p1, timeout=120))
        t2 = np.asarray(gp.infer(np.concatenate([t1, extra]), timeout=120))
        thit = gp.metrics.get("prefix_hit_tokens")
        gp.kv_cache.check_conservation()
    finally:
        gp.close()
    j1, j2, jhit = jax_refs["chat"]
    _assert_margins(tm, t2, len(t1) + 3)
    np.testing.assert_array_equal(t1, j1)
    np.testing.assert_array_equal(t2, j2)
    assert thit == jhit == 16


def test_prefix_hit_sampled_is_bit_identical_to_cold(pair):
    """Cold and warm schedulers draw the same tick seeds (one prefill tick
    each), so sampled tokens agree iff the shared rows are the cold rows."""
    _, tm = pair
    prompt = np.random.default_rng(31).integers(0, 160, 13).astype(np.int64)
    knobs = dict(temperature=0.9, top_k=4)
    cold = _serve(_port(tm, block_size=4, prefill_chunk=16,
                        prefix_cache=False), [prompt], **knobs)[0]
    warm = _port(tm, block_size=4, prefill_chunk=16)
    try:
        warm.infer(prompt, timeout=120, **knobs)
        warm._seed = itertools.count(1)         # realign the tick seeds
        out = np.asarray(warm.infer(prompt, timeout=120, **knobs))
        assert warm.metrics.get("prefix_hit_tokens") == 12
        warm.kv_cache.check_conservation()
    finally:
        warm.close()
    np.testing.assert_array_equal(out, cold)


def test_prefix_hit_under_speculation_matches_jax(pair, jax_refs):
    tm = pair[1]
    prompt = _spec_prompt()
    ref = jax_refs["spec"]
    gp = _port(tm, spec_k=2)
    try:
        got = [np.asarray(gp.infer(prompt, timeout=120)) for _ in range(2)]
        assert gp.metrics.get("prefix_hit_tokens") == 8
        assert gp.metrics.get("verify_ticks") >= 1
        gp.kv_cache.check_conservation()
    finally:
        gp.close()
    _assert_margins(tm, got[0], len(prompt))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_prefix_series_on_the_registry(pair):
    from paddle_tpu_torch.observability.metrics import render_prometheus

    _, tm = pair
    prompt = np.random.default_rng(41).integers(0, 160, 13).astype(np.int64)
    gp = _port(tm)
    try:
        gp.infer(prompt, timeout=120)
        gp.infer(prompt, timeout=120)
        text = render_prometheus(gp.metrics.registry)
        assert 'paddle_prefix_hit_tokens_total{component="continuous"} 8' \
            in text
        for state in ("cached", "shared", "indexed"):
            assert (f'paddle_prefix_cache_blocks{{component="continuous",'
                    f'state="{state}"}}') in text
        assert gp.metrics.snapshot()["prefix_hit_tokens"] == 8
    finally:
        gp.close()


def test_a_failed_lookup_is_a_cold_miss(pair):
    _, tm = pair
    prompt = np.random.default_rng(43).integers(0, 160, 13).astype(np.int64)
    gp = _port(tm)
    try:
        ref = np.asarray(gp.infer(prompt, timeout=120))

        def broken(*a, **k):
            raise RuntimeError("index fault")

        gp.prefix_cache.lookup = broken
        np.testing.assert_array_equal(gp.infer(prompt, timeout=120), ref)
        assert gp.metrics.get("prefix_hit_tokens") == 0
        del gp.prefix_cache.lookup
        np.testing.assert_array_equal(gp.infer(prompt, timeout=120), ref)
        assert gp.metrics.get("prefix_hit_tokens") == 8
        gp.kv_cache.check_conservation()
    finally:
        gp.close()


# ---------------------------------------------------------------- streaming
def test_stream_chunks_concat_to_the_buffered_suffix(pair, jax_refs):
    tm = pair[1]
    prompt = _prompt(53, 7)
    ref = jax_refs["stream"]
    gp = _port(tm)
    try:
        chunks = [np.asarray(c, np.int64)
                  for c in gp.infer_stream(prompt, timeout=120)]
        assert len(chunks) >= 2                 # tick-boundary delivery
        np.testing.assert_array_equal(np.concatenate(chunks), ref[7:])
        assert gp.pending() == 0
        gp.kv_cache.check_conservation()
    finally:
        gp.close()


def test_abandoned_stream_cancels_its_sequence(pair):
    _, tm = pair
    prompt = np.random.default_rng(59).integers(0, 160, 7).astype(np.int64)
    gp = _port(tm, max_new_tokens=24, decode_steps=1)
    try:
        it = gp.infer_stream(prompt, timeout=120)
        next(it)
        it.close()
        t0 = time.monotonic()
        while gp.pending() and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        assert gp.pending() == 0
        assert gp.metrics.get("timeouts") >= 1
        gp.kv_cache.check_conservation()
        assert gp.kv_cache.blocks_in_use == gp.prefix_cache.cached_blocks()
    finally:
        gp.close()


def _sse_events(body):
    out = []
    for block in body.decode().split("\n\n"):
        if block.strip():
            fields = dict(line.split(": ", 1) for line in block.split("\n"))
            out.append((fields["id"], fields["event"],
                        json.loads(fields["data"])))
    return out


def _post(port, prompt, headers):
    buf = io.BytesIO()
    np.savez(buf, ids=prompt)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=buf.getvalue(), headers=headers)
    return urllib.request.urlopen(req, timeout=120)


def test_server_sse_matches_the_buffered_answer(pair):
    _, tm = pair
    prompt = np.random.default_rng(61).integers(0, 160, 7).astype(np.int64)
    srv = InferenceServer(_port(tm), device="cpu").start()
    try:
        with _post(srv.port, prompt, {}) as r:
            buffered = np.load(io.BytesIO(r.read()))["out0"]
        with _post(srv.port, prompt, {"Accept": "text/event-stream"}) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "text/event-stream"
            tid = r.headers["X-Trace-Id"]
            events = _sse_events(r.read())
    finally:
        srv.stop(drain_timeout=10)
    assert [e for _, e, _ in events][-1] == "done"
    toks = []
    for eid, event, data in events:
        assert eid == tid and data["trace_id"] == tid
        if event == "tokens":
            toks.extend(data["tokens"])
    np.testing.assert_array_equal(np.asarray(toks, np.int64), buffered[7:])
    assert events[-1][2] == {"generated": 6, "prompt_len": 7,
                             "trace_id": tid}


def test_stream_headers_on_a_whole_batch_generator(pair):
    """X-Stream: sse on a whole-batch generator is a 400 before any byte;
    a malformed X-Stream is a 400; X-Stream: off overrides Accept."""
    _, tm = pair
    prompt = np.random.default_rng(67).integers(0, 160, 5).astype(np.int64)
    fixed = GenerateBatchingPredictor(tm, max_batch_size=2, max_delay_ms=5,
                                      max_new_tokens=6, block_size=8,
                                      num_blocks=32, device="cpu")
    srv = InferenceServer(fixed, device="cpu").start()

    def status(headers):
        try:
            with _post(srv.port, prompt, headers) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    try:
        assert status({"X-Stream": "sse"}) == 400
        assert status({"X-Stream": "nope"}) == 400
        assert status({"Accept": "text/event-stream",
                       "X-Stream": "off"}) == 200
        assert status({}) == 200
    finally:
        srv.stop(drain_timeout=10)
