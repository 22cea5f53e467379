"""Serving beyond the main path, on the card: multi-LoRA adapters through
every step program, and a replica fleet. Every test here is marked ``cuda``
and skips without a GPU.

This file imports torch and the port only (no JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda_serving.py

A small GPT with the kernels' head dim (2 layers, 2 heads of 64) serves
through the paged kernel with its step programs captured as CUDA graphs:

* an adapter's greedy tokens, in f32, equal those of a registry-free
  scheduler over a copy of the model with merged weights W + (alpha / r)
  A B, up to the first f32 near-tie, through the LoRA prefill / decode
  programs and, with ``spec_k`` > 0, the LoRA verify_step;
* LoRA ``generate_paged`` equals the merged model's ``generate_paged`` for
  every adapter, from one capture replayed with each adapter's bank row;
* in bf16, base traffic through a scheduler with a registry is bit-equal
  to the same requests without one (row 0 is the identity);
* a two-replica fleet over the model captures one program set per
  replica, over its own pool, and nothing more while it serves.
"""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (
    AdapterRegistry,
    ContinuousGenerateBatchingPredictor,
    PagedKVCache,
    ReplicaFleet,
)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import paged_attention as tpa

CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
           max_position=256)
ALPHA, RANK, NEW = 8.0, 4, 12
TIE_REL = 1e-4      # f32 near-tie: the LoRA and merged products differ by
                    # f32 rounding (~1e-6 relative), far below this
SERVE = dict(max_slots=4, prefill_chunk=16, decode_steps=2,
             max_new_tokens=NEW, max_seq_len=128, block_size=16,
             device="cuda")


def _gpt(dtype, seed=3):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device="cuda",
                               dtype=dtype, seed=seed)


def _pool(m, dtype):
    return PagedKVCache(*m._decode_cache_spec(), block_size=16,
                        num_blocks=32, dtype=dtype, device="cuda")


def _factors(reg, seed):
    rng = np.random.default_rng(seed)
    return {p: (rng.standard_normal((reg.dims(p)[0], RANK))
                .astype(np.float32) * 0.2,
                rng.standard_normal((RANK, reg.dims(p)[1]))
                .astype(np.float32) * 0.2)
            for p in reg.target_paths()}


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], n).astype(np.int64)
            for n in lens]


def _first_tie(model, seq, plen):
    """Generated positions of ``seq`` before the first f32 near-tie of a
    cache-free forward over it (all of them when there is none)."""
    with torch.no_grad():
        lg = model(torch.as_tensor(seq[None], device="cuda")).float()[
            0, plen - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    ties = np.nonzero(gap < TIE_REL * lg.abs().amax(dim=-1).cpu().numpy())[0]
    return int(ties[0]) if len(ties) else len(seq) - plen


def _serve(pred, jobs):
    """[(prompt, kwargs)] served concurrently -> outputs."""
    outs = [None] * len(jobs)

    def client(i):
        outs[i] = np.asarray(pred.infer(jobs[i][0], timeout=300,
                                        **jobs[i][1]))
    ts = [threading.Thread(target=client, args=(i,))
          for i in range(len(jobs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert all(o is not None for o in outs)
    return outs


@pytest.fixture(scope="module")
def lora_pair():
    """(f32 model, its registry with two adapters {name: row}, a merged
    copy, {path: module}, {path: original weight}, {name: factors})."""
    m = _gpt(torch.float32)
    reg = AdapterRegistry(m, max_adapters=4, max_rank=RANK)
    facs = {n: _factors(reg, 20 + i) for i, n in enumerate(("a", "b"))}
    rows = {n: reg.register(n, f, alpha=ALPHA) for n, f in facs.items()}
    merged = _gpt(torch.float32)
    mods = dict(torch.nn.Module.named_modules(merged._decode_layer()))
    orig = {p: mods[p].weight.detach().clone() for p in reg.target_paths()}
    yield m, reg, rows, merged, mods, orig, facs
    reg.close()


def _merge(lora_pair, name):
    _, _, _, _, mods, orig, facs = lora_pair
    with torch.no_grad():
        for path, (a, b) in facs[name].items():
            mods[path].weight.copy_(orig[path] + torch.as_tensor(
                a @ b * (ALPHA / RANK), device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("spec_k", [0, 3])
def test_lora_scheduler_equals_merged_weights(lora_pair, spec_k):
    m, reg, _, merged, *_ = lora_pair
    lora = ContinuousGenerateBatchingPredictor(
        m, kv_cache=_pool(m, torch.float32), adapters=reg, spec_k=spec_k,
        **SERVE)
    plain = ContinuousGenerateBatchingPredictor(
        merged, kv_cache=_pool(merged, torch.float32), **SERVE)
    try:
        compared = 0
        for name in ("a", "b"):
            _merge(lora_pair, name)
            qs = _prompts(5, (9, 23, 40))
            got = _serve(lora, [(q, dict(adapter=name)) for q in qs])
            want = _serve(plain, [(q, {}) for q in qs])
            for q, g, w in zip(qs, got, want):
                c = _first_tie(merged, w, len(q))
                compared += c
                np.testing.assert_array_equal(g[:len(q) + c],
                                              w[:len(q) + c])
        assert compared > 0
        kinds = {k[0]: r for k, r in m._runner_cache().items()
                 if ("pool", lora.kv_cache.uid) in k
                 and k[-1] == ("bank", reg.uid)}
        want_kinds = {"prefill_chunk",
                      "verify_step" if spec_k else "decode_step"}
        assert want_kinds <= set(kinds)
        assert all(kinds[k].captures == 1 and kinds[k].replays > 0
                   for k in want_kinds)
        if spec_k:
            assert lora.metrics.get("verify_ticks") > 0
    finally:
        lora.close()
        plain.close()


@pytest.mark.cuda
def test_lora_generate_paged_equals_merged_weights(lora_pair):
    m, reg, rows, merged, *_ = lora_pair
    kv, kvm = _pool(m, torch.float32), _pool(merged, torch.float32)
    qs = _prompts(9, (30, 17))
    P = 32
    ids = np.zeros((2, P), np.int64)
    for b, q in enumerate(qs):
        ids[b, :len(q)] = q
    plens = np.array([len(q) for q in qs])
    tab = np.stack([kv.reserve(b, P + NEW) for b in range(2)])
    tabm = np.stack([kvm.reserve(b, P + NEW) for b in range(2)])
    compared = 0
    for name in ("a", "b"):
        _merge(lora_pair, name)
        tpa.paged_decode_attention.launches = 0
        got = m.generate_paged(ids, plens, kv, tab, max_new_tokens=NEW,
                               adapters=reg, adapter_slots=[rows[name]] * 2)
        assert tpa.paged_decode_attention.launches == CFG["num_layers"] * NEW
        want = merged.generate_paged(ids, plens, kvm, tabm,
                                     max_new_tokens=NEW)
        for b, q in enumerate(qs):
            c = _first_tie(merged, np.concatenate([q, want[b]]), len(q))
            compared += c
            np.testing.assert_array_equal(got[b, :c], want[b, :c])
    assert compared > 0
    run = [r for k, r in m._runner_cache().items()
           if k[0] == "paged" and ("pool", kv.uid) in k]
    assert len(run) == 1 and run[0].captures == 1 and run[0].replays >= 1


@pytest.mark.cuda
def test_base_rows_bit_equal_to_a_scheduler_without_a_registry():
    m = _gpt(torch.bfloat16)
    reg = AdapterRegistry(m, max_adapters=2, max_rank=RANK)
    reg.register("a", _factors(reg, 3), alpha=ALPHA)
    lora = ContinuousGenerateBatchingPredictor(
        m, kv_cache=_pool(m, torch.bfloat16), adapters=reg, **SERVE)
    plain = ContinuousGenerateBatchingPredictor(
        m, kv_cache=_pool(m, torch.bfloat16), **SERVE)
    try:
        qs = _prompts(13, (7, 19, 33, 48))
        # base requests ride beside adapter traffic in the same batches
        jobs = [(q, {}) for q in qs] + [(q, dict(adapter="a")) for q in qs]
        got = _serve(lora, jobs)[:len(qs)]
        want = _serve(plain, [(q, {}) for q in qs])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    finally:
        lora.close()
        plain.close()
        reg.close()


@pytest.mark.cuda
def test_fleet_replicas_capture_one_set_each():
    m = _gpt(torch.bfloat16)
    fleet = ReplicaFleet.build(m, n_replicas=2, warmup=True, **SERVE)
    try:
        reps = [r.predictor for r in fleet._snapshot()]
        assert all(_ready(r) for r in reps)

        def caps(r):
            return {k: run.captures for k, run in m._runner_cache().items()
                    if ("pool", r.kv_cache.uid) in k}
        warm = [caps(r) for r in reps]
        assert [len(w) for w in warm] == [2, 2]
        assert all(set(w.values()) == {1} for w in warm)
        _serve(fleet, [(q, {}) for q in _prompts(17, (5, 11, 29, 40, 8,
                                                       21, 14, 33))])
        assert [caps(r) for r in reps] == warm
        assert all(r.metrics.get("completed") > 0 for r in reps)
    finally:
        fleet.close()


def _ready(pred, limit=300.0):
    t0 = time.monotonic()
    while not pred.ready():
        if time.monotonic() - t0 > limit:
            return False
        time.sleep(0.01)
    return True


# ------------------------------------------------------- the analysis seams
@pytest.mark.cuda
def test_paged_and_dense_operators_trace_on_fake_cuda_tensors():
    """The paged and dense kernels are operators with a fake: a step
    program traces over fake CUDA tensors with each kernel one node and
    nothing launched, and called for real the same programs launch the
    kernels, with the same counts as before the operators."""
    from paddle_tpu_torch.analysis.core import trace_runner
    from paddle_tpu_torch.ops import decode_attention as tda

    m = _gpt(torch.bfloat16)
    m.eval()
    kv = _pool(m, torch.bfloat16)
    S, C = 2, 8
    tables = np.zeros((S, 2), np.int32)
    tables[0] = kv.reserve("a", 24)[:2]
    ids = np.zeros((S, C), np.int64)
    lens = np.asarray([C, 0], np.int64)
    m.prefill_chunk(ids, np.zeros(S, np.int64), lens, kv, tables)
    run = m.compiled_prefill_chunk_runner(S, C)
    before = tpa.paged_decode_attention.launches
    gm, _ = trace_runner(m, run)
    assert tpa.paged_decode_attention.launches == before
    ops = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert ops.count("paddle_tpu_torch.paged_decode.default") == 2
    m.prefill_chunk(ids, np.zeros(S, np.int64), lens, kv, tables)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention.launches == before + 2   # a replay
    tda.decode_attention.launches = 0
    m.generate(torch.zeros((2, 8), dtype=torch.int64, device="cuda"),
               max_new_tokens=4)
    dense = tda.decode_attention.launches
    assert dense == 2 * 4                     # 2 layers x 4 forwards
    run = m.compiled_generate_runner(2, 8, 4)
    gm, _ = trace_runner(m, run, "decode")
    assert tda.decode_attention.launches == dense
    assert [str(n.target) for n in gm.graph.nodes].count(
        "paddle_tpu_torch.dense_decode.default") == 2


@pytest.mark.cuda
@pytest.mark.parametrize("max_seq_len", [128, None])
def test_hbm_budget_scheduler_on_the_card(max_seq_len):
    """hbm_budget= sizes the pool from plan_kv_pool on the card: clamped
    (2 slots x blocks_for(128, 16)) or fit-bound (the params plus 20 pages
    over 0.92: 19 live blocks and the scratch page); the gauges sum to the
    plan's total; greedy tokens equal a scheduler given num_blocks."""
    from paddle_tpu_torch.analysis import hbm

    m = _gpt(torch.bfloat16)
    pbb = hbm.per_block_bytes((2, 2, 64, 16, 0, "torch.bfloat16"))
    params = hbm.params_bytes_of(m)
    budget = (64 << 20) if max_seq_len else int((params + 20.5 * pbb)
                                                / 0.92)
    kw = dict(SERVE, max_slots=2, max_seq_len=max_seq_len)
    gp = ContinuousGenerateBatchingPredictor(m, hbm_budget=budget, **kw)
    try:
        nb = gp.kv_cache.num_blocks
        assert nb == (2 * 8 if max_seq_len else 19)
        assert gp.kv_cache.per_chip_pool_bytes() == (nb + 1) * pbb
        jobs = [(q, {}) for q in _prompts(31, (9, 17))]
        tpa.paged_decode_attention.launches = 0
        outs = _serve(gp, jobs)
        assert tpa.paged_decode_attention.launches > 0
        fams = {f.name: f for f in gp.metrics.registry.families()}
        parts = {k[0]: c.value
                 for k, c in fams["paddle_hbm_planned_bytes"].children()}
        assert sum(parts.values()) == gp._hbm_plan.planned_total_bytes
    finally:
        gp.close()
    direct = ContinuousGenerateBatchingPredictor(m, num_blocks=nb, **kw)
    try:
        for a, b in zip(outs, _serve(direct, jobs)):
            np.testing.assert_array_equal(a, b)
    finally:
        direct.close()


@pytest.mark.cuda
def test_tp_step_programs_trace_over_the_fake_backend_on_the_card():
    """The three step programs of a tp = 2 rank over the fake backend, on
    the card: each built by a step call that runs nothing, then traced
    over fake CUDA tensors — the paged kernel one operator node per layer,
    the collectives the declared kinds over groups of two, nothing
    launched; no process group left behind."""
    import torch.distributed as dist

    from paddle_tpu_torch.analysis import comms
    from paddle_tpu_torch.analysis.compilesurface import ServingConfig
    from paddle_tpu_torch.analysis.core import trace_runner

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with comms.tp_world(2) as axes:
        m = _gpt(torch.bfloat16)
        m.eval()
        kv = _pool(m, torch.bfloat16)
        assert kv.tp_sharded and m._tp() is not None
        cfg = ServingConfig(name="tp2", slots=2, prefill_chunk=8,
                            decode_steps=2, max_seq_len=64, spec_k=2,
                            kv_signature=kv.signature())
        before = tpa.paged_decode_attention.launches
        surfaces = comms.serving_comms_surfaces(m, kv, cfg, mesh_axes=axes)
        run = m.compiled_decode_step_runner(2, 2)
        gm, _ = trace_runner(m, run)
        assert tpa.paged_decode_attention.launches == before
        ops = [str(n.target) for n in gm.graph.nodes]
        assert ops.count("paddle_tpu_torch.paged_decode.default") == 2 * 2
    assert not dist.is_initialized()
    assert [s["path"] for s in surfaces] == ["prefill_chunk", "decode_step",
                                             "verify_step"]
    for s in surfaces:
        assert s["device"] == "cuda"
        assert {op.kind for op in s["ops"]} == {"all-reduce", "all-gather"}
        assert all(op.group_size == 2 for op in s["ops"])
    report = comms.analyze_step_comms(_surfaces=surfaces)
    assert report.high() == []
    budget = comms.smoke_comms_budget(surfaces)
    assert budget.ici_bytes_per_s == (
        450e9 if torch.cuda.get_device_name(0).startswith(
            "NVIDIA H100 80GB HBM3") else None)


@pytest.mark.cuda
def test_lock_witness_over_a_card_scheduler():
    """A continuous scheduler built and served on the card under the
    port's witness: its pool, slot, runner and capture locks are wrapped,
    the witness sees edges and no inversion, and the observed order with
    the static lock graph stays acyclic."""
    from paddle_tpu_torch.analysis import lockwitness
    from paddle_tpu_torch.analysis.threads import lock_order_graph

    m = _gpt(torch.bfloat16)
    w = lockwitness.activate(lockwitness.LockWitness())
    try:
        gp = ContinuousGenerateBatchingPredictor(m, **SERVE)
        try:
            outs = _serve(gp, [(q, {}) for q in _prompts(5, (9, 17, 12))])
        finally:
            gp.close()
    finally:
        lockwitness.deactivate()
    assert all(len(o) > 0 for o in outs)
    assert w.acquisitions > 0 and w.edges
    assert w.inversions == []
    assert w.check_static(lock_order_graph()) == []
