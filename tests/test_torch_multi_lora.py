"""Multi-LoRA serving in the port (``inference/adapters.py`` and the
adapter inputs of the step programs), held against the JAX package
(``tests/test_multi_lora.py``'s bodies).

* The registry's state machine, shapes and errors equal JAX's on the same
  model (same target paths, signature, bank bytes, rows, seeds).
* Slot 0 is the identity: base traffic through a scheduler with a
  registry is bit-identical to the scheduler without one, in the port.
* An adapter's greedy tokens equal those of a scheduler without a registry
  over the port model with merged weights ``W + (alpha / r) A B``, and
  equal the JAX LoRA scheduler's on the same numpy factors (f32 pools,
  ``decode_kernel="xla"`` on the JAX side), under the margin guard of
  ``serving_port``.
* Under ``applied`` the forward's logits equal JAX's within 1e-4 (rows 0,
  1 and 2 in one batch, row 0 bit-equal to the plain forward), and a
  sampled request through an adapter draws from the merged model's law
  (chi-square).
* Loads, unloads and mixes capture nothing new after warmup; the prefix
  cache never shares KV across adapters; an unload never tears an
  in-flight request; the HTTP taxonomy of ``X-Adapter``.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.adapters import AdapterRegistry as JaxRegistry
from paddle_tpu.inference.adapters import applied as jax_applied
from paddle_tpu.inference.scheduler import (
    ContinuousGenerateBatchingPredictor as JaxContinuous,
)
from paddle_tpu_torch.inference import (
    BASE_SLOT,
    AdapterRegistry,
    FaultInjector,
    GenerateBatchingPredictor,
    InferenceServer,
    PagedKVCache,
)
from paddle_tpu_torch.inference.adapters import applied
from paddle_tpu_torch.observability.metrics import render_prometheus
from serving_port import (
    assert_margins,
    continuous,
    jax_gpt,
    one_torch_thread,
    out0,
    port_of,
    post_npz,
    same_tokens,
)

VOCAB = 160
_one_thread = pytest.fixture(autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def pair():
    jm, cfg = jax_gpt(11, vocab=VOCAB)
    return jm, cfg, port_of(jm, cfg)


def _weights(reg, seed, rank=4, scale=0.05):
    rs = np.random.RandomState(seed)
    return {p: (rs.randn(*(reg.dims(p)[0], rank)).astype(np.float32) * scale,
                rs.randn(*(rank, reg.dims(p)[1])).astype(np.float32) * scale)
            for p in reg.target_paths()}


def _jax_sched(jm, reg=None, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("decode_steps", 2)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("decode_kernel", "xla")
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 32)
    kw.setdefault("max_seq_len", 40)
    return JaxContinuous(jm, adapters=reg, **kw)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).astype("int64") for n in lens]


ALPHA, RANK = 8.0, 4


@pytest.fixture(scope="module")
def jax_refs(pair):
    """JAX's scheduler answers on the same weights and factors, once."""
    jm = pair[0]
    refs = {}
    plain = _jax_sched(jm)
    try:
        refs["base"] = [np.asarray(plain.infer(p, timeout=300))
                        for p in _prompts(23, (3, 7, 13))]
    finally:
        plain.close()
    reg = JaxRegistry(jm, max_adapters=2, max_rank=8)
    reg.register("tuned", _weights(reg, 7, rank=RANK, scale=0.1),
                 alpha=ALPHA)
    gp = _jax_sched(jm, reg)
    try:
        refs["tuned"] = [np.asarray(gp.infer(p, timeout=300,
                                             adapter="tuned"))
                         for p in _prompts(29, (3, 5, 9))]
    finally:
        gp.close()
        reg.close()
    return refs


# ================================================================= registry
def test_registry_lifecycle_and_errors(pair):
    """The registry's state machine, the JAX body: discovery, registration
    errors, suffix resolution, refcounts with drain-on-unregister; and its
    shapes equal to JAX's registry on the same model."""
    jm, _, tm = pair
    reg = AdapterRegistry(tm, max_adapters=2, max_rank=8)
    jreg = JaxRegistry(jm, max_adapters=2, max_rank=8)
    try:
        paths = reg.target_paths()
        assert paths == jreg.target_paths()
        assert len(paths) == 4 and all("." in p for p in paths)
        assert reg.signature() == jreg.signature() == ("lora", 3, 8, 4)
        assert reg.bank_bytes() == jreg.bank_bytes() > 0
        assert all(reg.dims(p) == jreg.dims(p) for p in paths)

        w = _weights(reg, 0)
        row = reg.register("a", w)
        assert row == jreg.register("a", w)
        assert row != BASE_SLOT and reg.has("a") and reg.names() == ["a"]
        with pytest.raises(ValueError, match="already loaded"):
            reg.register("a", w)
        with pytest.raises(ValueError, match="unknown adapter"):
            reg.unregister("ghost")
        with pytest.raises(ValueError, match="unknown adapter"):
            reg.acquire("ghost")
        with pytest.raises(ValueError, match="empty adapter weights"):
            reg.register("empty", {})
        p0 = paths[0]
        in_f, out_f = reg.dims(p0)
        with pytest.raises(ValueError, match="expected A"):
            reg.register("bad", {p0: (np.zeros((in_f + 1, 2), np.float32),
                                      np.zeros((2, out_f), np.float32))})
        with pytest.raises(ValueError, match="rank"):
            reg.register("bad", {p0: (np.zeros((in_f, 9), np.float32),
                                      np.zeros((9, out_f), np.float32))})
        with pytest.raises(ValueError, match="unknown LoRA target"):
            reg.register("bad", {"nope": (np.zeros((2, 2), np.float32),
                                          np.zeros((2, 2), np.float32))})
        with pytest.raises(ValueError, match="ambiguous"):
            reg.register("bad", {"qkv_proj": (
                np.zeros((in_f, 2), np.float32),
                np.zeros((2, out_f), np.float32))})
        suffix = ".".join(p0.split(".")[1:])
        reg.register("partial", {suffix: w[p0]})
        with pytest.raises(RuntimeError, match="bank full"):
            reg.register("overflow", w)
        reg.unregister("partial")

        slot, seed = reg.acquire("a")
        jslot, jseed = jreg.acquire("a")
        assert (slot, seed) == (jslot, jseed)
        assert slot == row and seed.startswith(b"lora:a:")
        assert reg.stats() == {"loaded": 1, "pinned": 1, "free": 1}
        reg.unregister("a")
        assert not reg.has("a")
        with pytest.raises(ValueError):
            reg.acquire("a")
        assert reg.stats()["loaded"] == 1
        reg.release(slot)
        assert reg.stats() == {"loaded": 0, "pinned": 0, "free": 2}
        reg.release(slot)
        assert reg.acquire(None) == (BASE_SLOT, b"")
        reg.release(BASE_SLOT)
        # a freed row is zeroed in place: the identity again
        bank = reg.bank()
        assert all(float(bank["a"][p][row].abs().sum()) == 0.0
                   for p in paths)
    finally:
        reg.close()
        jreg.close()


def test_register_writes_the_bank_in_place_with_alpha_folded(pair):
    """The bank tensors are allocated once: a load writes its row in place
    (same storage), padded to r_max, with alpha / r folded into B — the
    rows JAX's registry holds for the same factors."""
    jm, _, tm = pair
    reg = AdapterRegistry(tm, max_adapters=2, max_rank=8)
    jreg = JaxRegistry(jm, max_adapters=2, max_rank=8)
    try:
        ptrs = {p: reg.bank()["a"][p].data_ptr() for p in reg.target_paths()}
        w = _weights(reg, 3, rank=3, scale=0.2)
        row = reg.register("x", w, alpha=6.0)
        jreg.register("x", w, alpha=6.0)
        jb = jreg.bank()
        for p in reg.target_paths():
            assert reg.bank()["a"][p].data_ptr() == ptrs[p]
            np.testing.assert_array_equal(
                reg.bank()["a"][p][row].numpy(), np.asarray(jb["a"][p][row]))
            np.testing.assert_allclose(
                reg.bank()["b"][p][row].numpy(), np.asarray(jb["b"][p][row]),
                rtol=1e-7, atol=0)
    finally:
        reg.close()
        jreg.close()


def test_lora_load_fault_leaves_registry_intact(pair):
    """``lora.load``: the failed register consumes no row, and loaded
    adapters and the bank are untouched."""
    tm = pair[2]
    f = FaultInjector()
    reg = AdapterRegistry(tm, max_adapters=2, faults=f)
    try:
        reg.register("good", _weights(reg, 1))
        before = {p: reg.bank()["b"][p].clone() for p in reg.target_paths()}
        f.install("lora.load", error=IOError("torn artifact"), times=1)
        with pytest.raises(IOError, match="torn artifact"):
            reg.register("corrupt", _weights(reg, 2))
        assert f.fired("lora.load") == 1
        assert reg.names() == ["good"]
        assert reg.stats() == {"loaded": 1, "pinned": 0, "free": 1}
        assert all(bool((reg.bank()["b"][p] == before[p]).all())
                   for p in before)
        reg.register("retry", _weights(reg, 2))
        assert reg.names() == ["good", "retry"]
    finally:
        reg.close()


# ============================================================ parity gates
def test_slot0_base_traffic_bit_identical_to_plain_scheduler(pair, jax_refs):
    """Row 0 is the identity: base requests through a scheduler with a
    registry (and a real adapter resident in another row) are bit-identical
    to the scheduler without one; both equal JAX's tokens."""
    _, cfg, tm = pair
    prompts = _prompts(23, (3, 7, 13))
    plain = continuous(tm)
    try:
        refs = [np.asarray(plain.infer(p, timeout=300)) for p in prompts]
    finally:
        plain.close()
    for p, r, jr in zip(prompts, refs, jax_refs["base"]):
        same_tokens(tm, r, jr, len(p))
    reg = AdapterRegistry(tm, max_adapters=2)
    lora = continuous(tm, adapters=reg)
    try:
        for p, ref in zip(prompts, refs):
            np.testing.assert_array_equal(lora.infer(p, timeout=300), ref)
        reg.register("resident", _weights(reg, 3, scale=0.5))
        for p, ref in zip(prompts, refs):
            np.testing.assert_array_equal(lora.infer(p, timeout=300), ref)
    finally:
        lora.close()
        reg.close()


def test_single_adapter_token_identical_to_merged_weights_and_jax(
        pair, jax_refs):
    """The banked gather is the adapter: an adapter's tokens equal a
    registry-free scheduler's over merged weights W + A B (alpha / r), and
    JAX's LoRA scheduler's on the same factors; the adapter changes the
    output somewhere."""
    jm, cfg, tm = pair
    reg = AdapterRegistry(tm, max_adapters=2, max_rank=8)
    w = _weights(reg, 7, rank=RANK, scale=0.1)
    reg.register("tuned", w, alpha=ALPHA)
    merged_tm = port_of(jm, cfg, delta={
        p + ".weight": np.float32(a @ b) * (ALPHA / RANK)
        for p, (a, b) in w.items()})
    lora = continuous(tm, adapters=reg)
    merged = continuous(merged_tm)
    try:
        diverged = False
        for p, jref in zip(_prompts(29, (3, 5, 9)), jax_refs["tuned"]):
            got = lora.infer(p, timeout=300, adapter="tuned")
            ref = merged.infer(p, timeout=300)
            assert_margins(merged_tm, ref, len(p))
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, jref)
            base = lora.infer(p, timeout=300)
            diverged = diverged or not np.array_equal(got[len(p):],
                                                      base[len(p):])
        assert diverged
    finally:
        lora.close()
        merged.close()
        reg.close()


# ====================================================== zero-capture gate
def test_mixed_adapter_traffic_never_captures_after_warmup(pair):
    """With warmup covering the configuration, mixed greedy / sampled /
    speculative traffic across adapters and base, with a load and an unload
    while serving, builds no new program: the runner cache does not grow
    and the post-ready counter stays 0."""
    _, cfg, tm0 = pair
    tm = port_of(pair[0], cfg)          # a fresh runner cache
    reg = AdapterRegistry(tm, max_adapters=3, max_rank=8)
    for i in range(2):
        reg.register(f"ad{i}", _weights(reg, 40 + i))
    gp = continuous(tm, adapters=reg, spec_k=2, warmup=True)
    try:
        deadline = time.monotonic() + 120
        while not gp.ready() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert gp.ready(), gp.warm_stats()
        assert not gp.warm_stats()["missing"]
        n_warm = len(tm._runner_cache())
        assert n_warm == 3              # prefill, decode, verify: LoRA form
        prompts = _prompts(31, (3, 5, 7, 9))
        gp.infer(prompts[0], timeout=300, adapter="ad0")
        assert len(tm._runner_cache()) == n_warm
        reg.register("ad2", _weights(reg, 42))
        kws = [dict(adapter="ad0"),
               dict(adapter="ad1", temperature=0.8, top_k=5),
               dict(adapter="ad2", spec=False), dict()]
        outs = [None] * 4

        def client(i):
            outs[i] = gp.infer(prompts[i], timeout=300, **kws[i])

        ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert all(o is not None for o in outs)
        reg.unregister("ad1")
        gp.infer(prompts[0], timeout=300, adapter="ad2")
        assert len(tm._runner_cache()) == n_warm
        for prog in ("prefill_chunk", "decode_step", "verify_step"):
            assert gp._recompile_counter.labels(
                gp._component, prog).value == 0, prog
        text = render_prometheus(gp.metrics.registry)
        assert "paddle_lora_requests_total" in text
        assert 'adapter="ad0"' in text and 'adapter="base"' in text
        assert "paddle_lora_adapters" in text
    finally:
        gp.close()
        reg.close()


def test_runner_lookups_see_the_base_programs_only(pair):
    """``compiled_*_runner`` return base programs: a LoRA runner (its key
    ends in the registry's ``("bank", uid)``) is never one of them."""
    tm = port_of(pair[0], pair[1])      # a fresh runner cache
    reg = AdapterRegistry(tm, max_adapters=2, max_rank=4)
    lora = continuous(tm, adapters=reg, spec_k=2, warmup=True)
    plain = None
    try:
        deadline = time.monotonic() + 120
        while not lora.ready() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert lora.ready(), lora.warm_stats()
        lora_runs = {id(r) for k, r in tm._runner_cache().items()
                     if k[-1] == ("bank", reg.uid)}
        assert len(lora_runs) == 3
        looks = (lambda: tm.compiled_prefill_chunk_runner(4, 4),
                 lambda: tm.compiled_decode_step_runner(4, 2),
                 lambda: tm.compiled_verify_step_runner(4, 3))
        assert [look() for look in looks] == [None, None, None]
        plain = continuous(tm, spec_k=2, warmup=True)
        deadline = time.monotonic() + 120
        while not plain.ready() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert plain.ready(), plain.warm_stats()
        found = [look() for look in looks]
        assert all(f is not None and id(f) not in lora_runs for f in found)
    finally:
        lora.close()
        if plain is not None:
            plain.close()
        reg.close()


def test_adapter_gather_span_traced(pair):
    tm = pair[2]
    reg = AdapterRegistry(tm, max_adapters=2)
    reg.register("traced", _weights(reg, 50))
    gp = continuous(tm, adapters=reg)
    try:
        gp.infer(np.arange(5, dtype=np.int64), timeout=300,
                 adapter="traced", trace_id="feedfacefeedface")
        spans = gp.tracer.trace("feedfacefeedface")
        gathers = [s for s in spans if s.name == "adapter_gather"]
        assert gathers, {s.name for s in spans}
        assert int(gathers[0].tags["distinct_adapters"]) >= 1
    finally:
        gp.close()
        reg.close()


# ===================================================== prefix-cache isolation
def test_prefix_cache_never_shares_kv_across_adapters(pair):
    """KV computed under adapter A never seeds a hit for adapter B or base;
    same-adapter multi-turn traffic still hits, and the hit path gives the
    cold path's tokens."""
    tm = pair[2]
    reg = AdapterRegistry(tm, max_adapters=2)
    reg.register("chat", _weights(reg, 60))
    reg.register("other", _weights(reg, 61))
    kw = dict(block_size=4, num_blocks=64, max_seq_len=64, max_new_tokens=4)
    gp = continuous(tm, adapters=reg, prefix_cache=True, **kw)
    try:
        rng = np.random.default_rng(37)
        prompt = rng.integers(0, VOCAB, 12).astype("int64")
        out1 = gp.infer(prompt, timeout=300, adapter="chat")
        assert gp.metrics.snapshot().get("prefix_hit_tokens", 0) == 0
        gp.infer(prompt, timeout=300, adapter="other")
        gp.infer(prompt, timeout=300)
        assert gp.metrics.snapshot().get("prefix_hit_tokens", 0) == 0
        turn2 = np.concatenate([out1, rng.integers(0, VOCAB, 3)]).astype(
            "int64")
        out2 = gp.infer(turn2, timeout=300, adapter="chat")
        assert gp.metrics.snapshot().get("prefix_hit_tokens", 0) >= 12
        assert len(out2) == len(turn2) + 4
        gp2 = continuous(tm, adapters=reg, **kw)
        try:
            np.testing.assert_array_equal(
                out2, gp2.infer(turn2, timeout=300, adapter="chat"))
        finally:
            gp2.close()
    finally:
        gp.close()
        reg.close()


def test_unregister_reload_same_name_does_not_reuse_stale_prefix(pair):
    tm = pair[2]
    reg = AdapterRegistry(tm, max_adapters=2)
    reg.register("v", _weights(reg, 70))
    gp = continuous(tm, adapters=reg, block_size=4, num_blocks=64,
                    prefix_cache=True, max_seq_len=64, max_new_tokens=4)
    try:
        prompt = np.arange(12, dtype=np.int64) % VOCAB
        gp.infer(prompt, timeout=300, adapter="v")
        reg.unregister("v")
        reg.register("v", _weights(reg, 71))
        gp.infer(prompt, timeout=300, adapter="v")
        assert gp.metrics.snapshot().get("prefix_hit_tokens", 0) == 0
    finally:
        gp.close()
        reg.close()


# ================================================================ chaos legs
def test_unload_racing_in_flight_request_drains_cleanly(pair):
    """unregister() while the adapter's request streams: the refcount pin
    keeps the row valid to the last token, the name is gone for new
    admissions at once, and the row frees when the stream retires."""
    tm = pair[2]
    reg = AdapterRegistry(tm, max_adapters=2)
    reg.register("doomed", _weights(reg, 80))
    gp = continuous(tm, adapters=reg, max_new_tokens=12, max_seq_len=64)
    try:
        prompt = np.arange(6, dtype=np.int64)
        ref = gp.infer(prompt, timeout=300, adapter="doomed")
        it = gp.infer_stream(prompt, timeout=300, adapter="doomed")
        first = next(it)
        assert reg.stats()["pinned"] == 1
        reg.unregister("doomed")
        with pytest.raises(ValueError, match="unknown adapter"):
            gp.infer(prompt, timeout=300, adapter="doomed")
        rest = [np.asarray(c) for c in it]
        got = np.concatenate([np.asarray(first)] + rest)
        np.testing.assert_array_equal(got, ref[len(prompt):])
        deadline = time.monotonic() + 30
        while reg.stats()["loaded"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert reg.stats() == {"loaded": 0, "pinned": 0, "free": 2}
        snap = gp.metrics.snapshot()
        assert snap["admitted_seqs"] == snap["retired_seqs"]
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
    finally:
        gp.close()
        reg.close()


def test_unknown_adapter_400_mid_storm(pair):
    tm = pair[2]
    reg = AdapterRegistry(tm, max_adapters=2)
    reg.register("live", _weights(reg, 90))
    gp = continuous(tm, adapters=reg)
    srv = InferenceServer(gp, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    rng = np.random.default_rng(41)
    lens = [3 + i % 5 for i in range(9)]
    ids = [rng.integers(0, VOCAB, n).astype("int64") for n in lens]
    results = {}

    def client(i):
        if i % 3 == 2:
            results[i] = post_npz(base, "/generate", ids[i],
                                  {"X-Adapter": f"ghost-{i}"})[0]
        else:
            hdrs = {"X-Adapter": "live"} if i % 3 else {}
            results[i] = post_npz(base, "/generate", ids[i], hdrs)[0]

    try:
        ts = [threading.Thread(target=client, args=(i,)) for i in range(9)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        for i in range(9):
            assert results[i] == (400 if i % 3 == 2 else 200), (i, results)
        srv.stop(drain_timeout=10)
        snap = gp.metrics.snapshot()
        assert snap["admitted_seqs"] == snap["retired_seqs"] == 6
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
    finally:
        srv.stop(drain_timeout=2)
        gp.close()
        reg.close()


# ============================================================= HTTP taxonomy
def test_x_adapter_header_taxonomy(pair):
    tm = pair[2]
    reg = AdapterRegistry(tm, max_adapters=2)
    reg.register("strong", _weights(reg, 95, scale=0.5))
    gp = continuous(tm, adapters=reg)
    srv = InferenceServer(gp, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    prompt = np.arange(5, dtype=np.int64)
    try:
        status, body, _ = post_npz(base, "/generate", prompt)
        assert status == 200
        base_out = out0(body)
        status, body, _ = post_npz(base, "/generate", prompt,
                                   {"X-Adapter": "strong"})
        assert status == 200
        routed = out0(body)
        assert not np.array_equal(routed, base_out)
        status, body, _ = post_npz(base, "/generate", prompt,
                                   {"X-Adapter": "  strong  "})
        np.testing.assert_array_equal(
            out0(body), routed)
        for hdrs in ({"X-Adapter": ""}, {"X-Adapter": "   "},
                     {"X-Adapter": "ghost"}):
            assert post_npz(base, "/generate", prompt, hdrs)[0] == 400, hdrs
        srv.stop(drain_timeout=10)
    finally:
        srv.stop(drain_timeout=2)
        gp.close()
        reg.close()


def test_x_adapter_rejected_without_registry_or_on_fixed_batch(pair):
    tm = pair[2]
    prompt = np.arange(5, dtype=np.int64)
    gp = continuous(tm)
    assert gp.supports_adapters is False
    with pytest.raises(ValueError, match="AdapterRegistry"):
        gp.infer(prompt, timeout=60, adapter="x")
    srv = InferenceServer(gp, device="cpu").start()
    try:
        assert post_npz(f"http://127.0.0.1:{srv.port}", "/generate", prompt,
                        {"X-Adapter": "x"})[0] == 400
    finally:
        srv.stop(drain_timeout=2)
        gp.close()
    fixed = GenerateBatchingPredictor(
        tm, max_batch_size=2, max_delay_ms=1, max_new_tokens=6, block_size=8,
        num_blocks=32, device="cpu")
    assert fixed.supports_adapters is False
    srv = InferenceServer(fixed, device="cpu").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert post_npz(base, "/generate", prompt, {"X-Adapter": "x"})[0] \
            == 400
        assert post_npz(base, "/generate", prompt)[0] == 200
    finally:
        srv.stop(drain_timeout=2)
        fixed.close()


# ============================================================= slow soak
@pytest.mark.slow
def test_multi_adapter_storm_parity_soak(pair):
    """20 concurrent requests across 4 adapters + base: every output equal
    to a sequential run of the same request on the same scheduler."""
    tm = pair[2]
    reg = AdapterRegistry(tm, max_adapters=4, max_rank=8)
    weights = {f"s{i}": _weights(reg, 200 + i, scale=0.1) for i in range(4)}
    for n, w in weights.items():
        reg.register(n, w, alpha=8.0)
    rng = np.random.default_rng(43)
    prompts = {n: [rng.integers(0, VOCAB, 3 + j).astype("int64")
                   for j in range(4)] for n in [None] + list(weights)}
    gp = continuous(tm, adapters=reg)
    try:
        refs = {n: [gp.infer(p, timeout=300, adapter=n)
                    for p in prompts[n]] for n in prompts}
        assert any(not np.array_equal(refs[n][j],
                                      gp.infer(prompts[n][j], timeout=300))
                   for n in weights for j in range(4))
        results = {}

        def client(name, j):
            results[(name, j)] = gp.infer(prompts[name][j], timeout=600,
                                          adapter=name)

        ts = [threading.Thread(target=client, args=(n, j))
              for n in prompts for j in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        for name in prompts:
            for j in range(4):
                np.testing.assert_array_equal(results[(name, j)],
                                              refs[name][j])
        snap = gp.metrics.snapshot()
        assert snap["admitted_seqs"] == snap["retired_seqs"]
        assert gp.kv_cache.blocks_in_use == 0
        gp.kv_cache.check_conservation()
    finally:
        gp.close()
        reg.close()


# ======================================================== logits and law
def test_lora_forward_logits_match_jax(pair):
    """Under ``applied`` each package's forward adds its slots' deltas:
    three sequences through rows 0 (base), 1 and 2 of banks loaded with the
    same factors give JAX's logits within 1e-4 (f32, a 2-layer model)."""
    jm, _, tm = pair
    reg = AdapterRegistry(tm, max_adapters=2, max_rank=8)
    jreg = JaxRegistry(jm, max_adapters=2, max_rank=8)
    try:
        for i, name in enumerate(("x", "y")):
            w = _weights(reg, 11 + i, rank=4 + i, scale=0.2)
            reg.register(name, w, alpha=4.0)
            jreg.register(name, w, alpha=4.0)
        ids = np.random.default_rng(5).integers(0, VOCAB, (3, 9))
        rows = np.array([0, 1, 2], np.int32)
        with jax_applied(jreg.bank(), jnp.asarray(rows)):
            ref = np.asarray(jm(paddle.to_tensor(ids))._value)
        with torch.no_grad(), applied(reg.bank(), torch.from_numpy(rows)):
            got = tm(torch.from_numpy(ids)).numpy()
        with torch.no_grad():
            plain = tm(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got[0], plain[0])    # row 0: base
        assert np.abs(got[1:] - plain[1:]).max() > 1e-2    # deltas bite
    finally:
        reg.close()
        jreg.close()


def test_lora_sampled_first_token_law_chi_square(pair):
    """A sampled request through an adapter draws its first token from the
    merged model's temperature / top-k law (chi-square, 400 draws)."""
    jm, cfg, tm = pair
    reg = AdapterRegistry(tm, max_adapters=2, max_rank=8)
    w = _weights(reg, 17, rank=4, scale=0.2)
    reg.register("law", w, alpha=8.0)
    merged = port_of(jm, cfg, delta={
        p + ".weight": np.float32(a @ b) * (8.0 / 4)
        for p, (a, b) in w.items()})
    try:
        prompt = np.random.default_rng(9).integers(0, VOCAB, 6)
        with torch.no_grad():
            lg = merged(torch.from_numpy(prompt)[None]).float()[0, -1]
        T, K, N = 0.9, 6, 400
        cut = lg / T
        kth = cut.topk(K).values[-1]
        cut = torch.where(cut >= kth, cut, torch.full_like(cut, -1e30))
        probs = torch.softmax(cut, -1).numpy()
        kv = PagedKVCache(*tm._decode_cache_spec(), block_size=8,
                          num_blocks=4, dtype=torch.float32, device="cpu")
        kv.reserve("r", 8)
        table = kv.block_table("r", pad_to=1)[None]
        ids = np.zeros((1, 8), np.int64)
        ids[0, :6] = prompt
        counts = np.zeros(VOCAB, np.int64)
        for seed in range(N):
            tok = tm.prefill_chunk(ids, [0], [6], kv, table, temperature=T,
                                   top_k=K, seed=seed, adapters=reg,
                                   adapter_slots=[1])
            counts[int(tok[0])] += 1
        support = probs > 0
        assert counts[~support].sum() == 0
        exp = probs[support] * N
        chi2 = float(((counts[support] - exp) ** 2 / exp).sum())
        assert chi2 < 25.0, (chi2, counts[support], exp)   # df 5, p < 1e-3
    finally:
        reg.close()
