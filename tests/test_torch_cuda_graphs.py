"""The step programs as CUDA graphs, on the card. Every test here is marked
``cuda`` and skips without a GPU.

This file imports torch and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda_graphs.py

A small GPT with the kernels' head dim (2 layers, 2 heads of 64, bf16)
runs each step program twice on the same inputs: once as its body without
capture, once replayed from its graph. Greedy and sampled tokens must be
identical at one seed, and a captured paged forward's logits equal to its
body's (max |diff| 0: the same kernels on the same inputs). The kernel
launch counts must go on counting through replays, and a body that
synchronises with the host must make its capture raise. generate_paged
replays its one graph per key with the body's tokens; a scheduler's warmup
captures every program and leaves the pool's live pages bit-equal; a
speculative scheduler captures verify_step once per pool; a LoRA program
replays its body's tokens and reads bank rows written after its capture.
A graph released during another's capture (by its last reference or by
the collector) leaves that capture whole, and a later failed capture into
a pool names the pool's first failure.
"""
import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (
    ContinuousGenerateBatchingPredictor,
    PagedKVCache,
)
from paddle_tpu_torch.jit.graphs import StepRunner
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import paged_attention as tpa

CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
           max_position=256)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device="cuda",
                               dtype=torch.bfloat16, seed=3)


def _pool(m, slots=3):
    kv = PagedKVCache(*m._decode_cache_spec(), block_size=16,
                      num_blocks=slots * 8, dtype=torch.bfloat16,
                      device="cuda")
    return kv, np.stack([kv.reserve(i, 128) for i in range(slots)])


def _programs(m, kv, tables):
    rng = np.random.default_rng(0)
    S = tables.shape[0]
    lens = np.array([40, 7, 90])
    chunk = rng.integers(0, 256, (S, 16))
    vchunk = rng.integers(0, 256, (S, 4))
    act = np.array([True, True, False])
    return {
        "prefill_chunk": (
            lambda **kw: m.prefill_chunk(chunk, lens, np.array([16, 5, 0]),
                                         kv, tables, **kw),
            lambda: m.compiled_prefill_chunk_runner(S, 16)),
        "decode_step": (
            lambda **kw: m.decode_step(chunk[:, 0], lens, act, kv, tables,
                                       steps=3, max_lens=lens + 2, **kw),
            lambda: m.compiled_decode_step_runner(S, 3)),
        "verify_step": (
            lambda **kw: m.verify_step(vchunk, lens, np.array([3, 1, 2]),
                                       act, kv, tables, **kw),
            lambda: m.compiled_verify_step_runner(S, 4)),
    }


def _flat(x):
    return np.concatenate([np.asarray(a).ravel() for a in
                           (x if isinstance(x, tuple) else (x,))])


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["prefill_chunk", "decode_step",
                                     "verify_step"])
@pytest.mark.parametrize("sampler", [{}, dict(temperature=0.9, top_k=20,
                                              seed=5)])
def test_replay_gives_the_bodys_tokens(model, program, sampler):
    kv, tables = _pool(model)
    call, runner = _programs(model, kv, tables)[program]
    first = call(**sampler)                  # the body, then the capture
    run = runner()
    assert run.captures == 1 and run.replays == 0
    with run._eager():
        body = call(**sampler)
    replay = call(**sampler)
    assert run.replays == 1 and run.captures == 1
    np.testing.assert_array_equal(_flat(replay), _flat(body))
    np.testing.assert_array_equal(_flat(first), _flat(body))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", [{}, dict(temperature=0.9, top_k=20,
                                              seed=5)])
def test_generate_replay_gives_the_bodys_tokens(model, sampler):
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (2, 24)),
                          device="cuda")
    first = model.generate(ids, max_new_tokens=6, **sampler)
    run = model.compiled_generate_runner(2, 24, 6)
    assert run.captures == 2                 # prefill and decode
    replays = run.replays
    with run._eager():
        body = model.generate(ids, max_new_tokens=6, **sampler)
    assert run.replays == replays
    replay = model.generate(ids, max_new_tokens=6, **sampler)
    assert run.captures == 2 and run.replays == replays + 6
    assert torch.equal(replay, body) and torch.equal(first, body)


@pytest.mark.cuda
def test_captured_forward_logits_equal_the_bodys(model):
    kv, tables = _pool(model)
    S, C = 3, 16
    ids = np.random.default_rng(2).integers(0, 256, (S, C))
    offs = np.array([40, 7, 90])

    def body(inp, out):
        valid = torch.ones((S, C), dtype=torch.bool, device="cuda")
        step = model._device_step(inp["offsets"], C, inp["tables"], valid,
                                  kv.block_size, kv.scratch_slot)
        lg = model._decode_call(None, inp["ids"], kv.k_pages, kv.v_pages,
                                step, "kernel")
        out["logits"].copy_(lg.float())

    run = StepRunner("cuda", {"ids": ((S, C), torch.int64),
                              "offsets": ((S,), torch.int64),
                              "tables": (tables.shape, torch.int32)},
                     {"logits": ((S, C, 256), torch.float32)}, {"fwd": body})
    run.fill(ids=ids, offsets=offs, tables=tables)
    with run._eager():
        run.run("fwd")
    eager = run.read()["logits"]
    run.run("fwd")
    run.run("fwd")
    replay = run.read()["logits"]
    assert np.isfinite(eager).all()
    diff = float(np.abs(replay - eager).max())
    print(f"captured forward: max |replay - body| = {diff}")
    assert diff == 0.0


@pytest.mark.cuda
def test_launch_counts_go_on_through_replays(model):
    kv, tables = _pool(model)
    call, _ = _programs(model, kv, tables)["decode_step"]
    L = model.config.num_layers
    call()                                   # body + capture
    before = tpa.paged_decode_attention.launches
    for _ in range(4):
        call()
    assert tpa.paged_decode_attention.launches - before == 4 * 3 * L
    ids = np.random.default_rng(4).integers(0, 256, (2, 8))
    model.generate(ids, max_new_tokens=3)
    before = tda.decode_attention.launches
    model.generate(ids, max_new_tokens=4)    # the same bucket: replays
    assert tda.decode_attention.launches - before == 4 * L


@pytest.mark.cuda
@pytest.mark.parametrize("sync", ["item", "nonzero", "cpu"])
def test_a_host_sync_in_the_body_makes_the_capture_raise(model, sync):
    def body(inp, out):
        x = inp["x"] * 2
        if sync == "item":
            x = x + float(x.sum())
        elif sync == "nonzero":
            x = x[x.nonzero()[:, 0]].sum() + x
        else:
            x = x + torch.as_tensor(x.cpu().numpy(), device="cuda")
        out["y"].copy_(x)

    run = StepRunner("cuda", {"x": ((4,), torch.float32)},
                     {"y": ((4,), torch.float32)}, {"f": body})
    run.fill(x=np.arange(4, dtype=np.float32))
    with pytest.raises(RuntimeError):
        run.run("f")                         # the body runs; its capture
    assert "f" not in run.graphs             # fails and nothing is kept
    with pytest.raises(RuntimeError):
        run.run("f")                         # no quiet fallback either
    torch.cuda.synchronize()
    assert float(torch.ones(3, device="cuda").sum()) == 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", [{}, dict(temperature=0.9, top_k=20,
                                              seed=5)])
def test_generate_paged_replay_gives_the_bodys_tokens(model, sampler):
    kv, tables = _pool(model, slots=2)
    rng = np.random.default_rng(6)
    plens = np.array([24, 11])
    ids = rng.integers(0, 256, (2, 24))

    def call():
        return model.generate_paged(ids, plens, kv, tables, max_new_tokens=8,
                                    **sampler)

    first = call()                           # the body, then the capture
    run = model.compiled_generate_paged_runner(2, 24, 8)
    assert run.captures == 1 and run.replays == 0
    with run._eager():
        body = call()
    replay = call()
    assert run.captures == 1 and run.replays == 1
    np.testing.assert_array_equal(replay, body)
    np.testing.assert_array_equal(first, body)


def _wait_ready(gp, limit=120):
    t0 = time.monotonic()
    while not gp.ready() and time.monotonic() - t0 < limit:
        time.sleep(0.01)
    assert gp.ready()


@pytest.mark.cuda
def test_warmup_captures_and_leaves_the_live_pages_bit_equal(model):
    kv = PagedKVCache(*model._decode_cache_spec(), block_size=16,
                      num_blocks=24, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for p in kv.k_pages + kv.v_pages:
        p.copy_(torch.randn(p.shape, generator=g, device="cuda"))
    before = [p[:, :kv.num_blocks].clone() for p in kv.k_pages + kv.v_pages]
    gp = ContinuousGenerateBatchingPredictor(
        model, kv_cache=kv, max_slots=3, prefill_chunk=16, decode_steps=2,
        max_new_tokens=8, max_seq_len=128, spec_k=3, warmup=True,
        device="cuda")
    try:
        _wait_ready(gp)
        st = gp.warm_stats()
        assert st["missing"] == [] and st["programs"] == 3
        caps = {k[0]: r.captures for k, r in model._generate_cache.items()
                if ("pool", kv.uid) in k}
        assert caps == {"prefill_chunk": 1, "decode_step": 1,
                        "verify_step": 1}
    finally:
        gp.close()
    torch.cuda.synchronize()
    for a, b in zip(before, kv.k_pages + kv.v_pages):
        assert torch.equal(a, b[:, :kv.num_blocks])


@pytest.mark.cuda
def test_spec_scheduler_captures_verify_step_once_per_pool(model):
    rng = np.random.default_rng(8)
    prompts = [np.tile(rng.integers(0, 256, 4), 6)[:n].astype(np.int64)
               for n in (9, 17, 23, 12)]
    for _ in range(2):
        kv = PagedKVCache(*model._decode_cache_spec(), block_size=16,
                          num_blocks=24, dtype=torch.bfloat16, device="cuda")
        gp = ContinuousGenerateBatchingPredictor(
            model, kv_cache=kv, max_slots=3, prefill_chunk=16,
            decode_steps=2, max_new_tokens=12, max_seq_len=128, spec_k=3,
            device="cuda")
        outs = {}
        try:
            ts = [threading.Thread(target=lambda i=i: outs.update(
                {i: gp.infer(prompts[i], timeout=120)}))
                for i in range(len(prompts))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert len(outs) == len(prompts)
            assert gp.metrics.get("verify_ticks") >= 2
            kv.check_conservation()
        finally:
            gp.close()
        verify = [r for k, r in model._generate_cache.items()
                  if k[0] == "verify_step" and ("pool", kv.uid) in k]
        assert len(verify) == 1 and verify[0].captures == 1
        assert verify[0].replays == gp.metrics.get("verify_ticks") - 1


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["prefill_chunk", "decode_step",
                                     "verify_step"])
def test_lora_replay_gives_the_bodys_tokens_and_sees_bank_writes(model,
                                                                 program):
    """A LoRA program captured over the bank replays the body's tokens; a
    load written into the bank after the capture is read by the replay
    (the graph holds the bank's addresses), and row 0 stays the base."""
    from paddle_tpu_torch.inference import AdapterRegistry

    reg = AdapterRegistry(model, max_adapters=2, max_rank=4)
    rng = np.random.default_rng(7)

    def factors():
        return {p: (rng.standard_normal((reg.dims(p)[0], 4))
                    .astype(np.float32) * 0.3,
                    rng.standard_normal((4, reg.dims(p)[1]))
                    .astype(np.float32) * 0.3)
                for p in reg.target_paths()}

    try:
        reg.register("a", factors())
        kv, tables = _pool(model)
        call, _ = _programs(model, kv, tables)[program]
        rows = np.array([1, 0, 1], np.int32)
        lora = dict(adapters=reg, adapter_slots=rows)
        call(**lora)                              # the body, then capture
        run = next(r for k, r in model._generate_cache.items()
                   if k[0] == program and ("bank", reg.uid) in k
                   and ("pool", kv.uid) in k)
        with run._eager():
            body = call(**lora)
        replay = call(**lora)
        assert run.captures == 1 and run.replays >= 1
        np.testing.assert_array_equal(_flat(replay), _flat(body))
        reg.register("b", factors())              # after the capture
        lora_b = dict(adapters=reg, adapter_slots=np.array([2, 0, 2],
                                                           np.int32))
        with run._eager():
            body_b = call(**lora_b)
        np.testing.assert_array_equal(_flat(call(**lora_b)), _flat(body_b))
        assert run.captures == 1
    finally:
        reg.close()


def _doubler(pool, extra=None):
    """A runner of one program, y = 2 x, whose body first calls ``extra``
    with its call number (1: the eager first run, 2: the capture)."""
    calls = []

    def body(inp, out):
        calls.append(1)
        if extra is not None:
            extra(len(calls))
        out["y"].copy_(inp["x"] * 2)

    return StepRunner("cuda", {"x": ((4,), torch.float32)},
                      {"y": ((4,), torch.float32)}, {"f": body}, pool=pool)


def _doubled(run, x):
    run.fill(x=x)
    run.run("f")
    return run.read()["y"]


@pytest.mark.cuda
@pytest.mark.parametrize("released_by", ["collector", "last_reference"])
def test_a_graph_released_during_a_capture_leaves_it_whole(model,
                                                           released_by):
    """A graph destroyed while another is captured (its runner's last
    reference dropped, or a dead cycle collected on the capturing thread)
    is an operation the capture forbids: the capture must succeed, and the
    graph be destroyed after it."""
    from paddle_tpu_torch.jit import graphs

    pool = torch.cuda.graph_pool_handle()
    x = np.arange(4, dtype=np.float32)
    old = _doubler(pool)
    for _ in range(2):                       # the capture, then a replay
        np.testing.assert_array_equal(_doubled(old, x), 2 * x)
    assert old.captures == 1 and old.replays == 1
    held = [old.graphs.pop("f")]
    del old
    released = []

    def release(call):
        if call != 2:
            return
        cap = held.pop()
        released.append(weakref.ref(cap))
        if released_by == "last_reference":
            del cap
        else:               # a dead cycle, then allocations that would
            cyc = [cap]     # run the collector at a threshold of 1
            cyc.append(cyc)
            del cap, cyc
            for _ in range(2000):
                [[]]

    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        new = _doubler(pool, release)
        np.testing.assert_array_equal(_doubled(new, x), 2 * x)
    finally:
        gc.set_threshold(*thresholds)
    assert new.captures == 1 and "f" in new.graphs
    gc.collect()
    assert released[0]() is None and graphs._DEFERRED == []
    np.testing.assert_array_equal(_doubled(new, x + 1), 2 * (x + 1))
    assert new.replays == 1


@pytest.mark.cuda
def test_a_later_failure_in_a_pool_names_the_first(model):
    """A capture that fails (a host sync in its body) leaves its memory
    pool marked as recording, so a later capture into the pool fails with
    "already recording": its message must name the pool's first failure."""
    from paddle_tpu_torch.jit.graphs import CaptureError

    pool = torch.cuda.graph_pool_handle()
    x = np.arange(4, dtype=np.float32)

    def sync(call):
        torch.cuda.current_stream().synchronize()

    said = []
    for _ in range(2):
        bad = _doubler(pool, sync)
        bad.fill(x=x)
        with pytest.raises(CaptureError) as e:
            bad.run("f")
        said.append(str(e.value))
    first = said[0].removeprefix("CUDA graph capture failed: ")
    assert "already recording" not in said[0]
    assert first.splitlines()[0] in said[1]
    good = _doubler(torch.cuda.graph_pool_handle())
    for _ in range(2):
        np.testing.assert_array_equal(_doubled(good, x), 2 * x)
    assert good.captures == 1 and good.replays == 1
