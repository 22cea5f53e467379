"""The port's counterparts of ``__graft_entry__.py``'s ``dryrun_multichip``
legs not held elsewhere, on gloo ranks: each asserts what JAX's leg
asserts, with JAX's bounds, and holds its numbers to JAX's where JAX's leg
prints one.

* pp-hybrid (``:171``): one ``train_batch`` of ``gpt_pipeline(gpt_tiny(),
  2)`` over ``[pp 2, dp 2, mp 2]`` with ZeRO-2, 1F1B and the tied
  embeddings shared by the two stages; every rank reports the batch's
  mean loss, JAX's single-device micro-batch loss on the same weights
  (1e-5 relative), each stage holding its own layers.
* ep (``:363``): one ``TrainStep`` of the ``[dp 2, ep 4]`` MoE model
  through ``DataParallel``; the mean loss is JAX's step loss on the whole
  batch (1e-5 relative), no token dropped.
* llama-zero3 (``:267``): ``llama_tiny()`` under ``ShardingStage3`` at
  dp 8: each stage-3 parameter's local fraction is 1/8, and the 5-step
  loss trajectory is within 5e-4 of JAX's unsharded run, JAX's bound.
* ring at S 16384 (``:314``): causal ring attention over sep 8 (B 1, H 2,
  D 32, f32): the last position's row within 2e-4 of the numpy
  reference.
* serving-tp (``:408``): ``serving_mesh(dp=2, tp=2)`` over 4 ranks (GPT
  with ``num_kv_heads`` 2), a ``ReplicaFleet`` of two lockstep groups
  routed from rank 0 (the other replica through an rpc proxy): 8
  threaded requests token-identical to a single-rank scheduler, each
  replica's per-rank pool bytes 1/tp of the logical pool, every replica
  ``ready`` at the end; then the remote replica retired over rpc reads
  dead and the router serves from the other. Then, as JAX's leg lints
  the decode program's collectives, every rank traces the decode step at
  tp 2 over the job's real gloo groups: no HIGH finding, and the surface
  equal to the fake backend's in this process.

The 8-rank bodies share one spawn, and the 4-rank body another.
"""
import math

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.jit.train import TrainStep as JaxTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.inference import PagedKVCache
from paddle_tpu_torch.models.gpt import GPTConfig

import dist_ranks
import test_torch_expert_parallel as ep_test
from serving_port import continuous, one_torch_thread

WORLD = 8


def _cfg_dict(c):
    return {k: v for k, v in vars(c).items() if not k.startswith("_")}


def _pp_hybrid():
    cfg = jgpt.gpt_tiny()
    with paddle.utils.unique_name.guard():
        paddle.seed(0)
        model = jgpt.gpt_pipeline(cfg, num_stages=1)
    state = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (4, 32)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    losses = [float(model.loss_fn(model(paddle.to_tensor(mx)),
                                  paddle.to_tensor(my)))
              for mx, my in zip(np.split(ids, 2), np.split(labels, 2))]
    return ({"config": _cfg_dict(cfg), "state": state, "ids": ids,
             "labels": labels}, float(np.mean(losses)))


def _llama_zero3():
    cfg = jllama.llama_tiny()
    with paddle.utils.unique_name.guard():
        paddle.seed(0)
        jm = jllama.LlamaForCausalLM(cfg)
    state = {k: np.asarray(v) for k, v in jm.raw_state().items()}
    x = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                         (8, 32)).astype(np.int64)
    y = np.roll(x, -1, axis=1)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=jm.parameters())
    step = JaxTrainStep(jm, lambda logits, loss: loss, opt)
    losses = [float(step(paddle.to_tensor(x), labels=paddle.to_tensor(y)))
              for _ in range(5)]
    return {"config": _cfg_dict(cfg), "state": state, "ids": x,
            "labels": y}, losses


RING = dict(S=16384, B=1, H=2, D=32, seed=0)


def _ring_reference():
    rs = np.random.RandomState(RING["seed"])
    shape = (RING["B"], RING["S"], RING["H"], RING["D"])
    q = rs.randn(*shape).astype(np.float32) * 0.1
    k = rs.randn(*shape).astype(np.float32) * 0.1
    v = rs.randn(*shape).astype(np.float32) * 0.1
    t = RING["S"] - 1
    scores = np.einsum("hd,thd->ht", q[0, t], k[0, :t + 1]) / math.sqrt(
        RING["D"])
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("ht,thd->hd", p, v[0, :t + 1])


@pytest.fixture(scope="module")
def eight():
    pp_in, pp_loss = _pp_hybrid()
    zero_in, zero_losses = _llama_zero3()
    ep_in, ep_ref = ep_test._ep_case(1, 8, seed=3)
    ranks = dist_ranks.run_ranks(
        ["dist_model_bodies:body_pp_hybrid",
         "dist_model_bodies:body_ep_dryrun",
         "dist_model_bodies:body_llama_zero3",
         "dist_model_bodies:body_ring_16k"], WORLD,
        {"pp_hybrid": pp_in, "ep_dryrun": ep_in, "llama_zero3": zero_in,
         "ring": RING}, deadline_s=300)
    ref = {"pp_loss": pp_loss, "ep": ep_ref, "zero_losses": zero_losses,
           "ring": _ring_reference()}
    return ref, ranks


def _leg(ranks, name):
    return [r[f"dist_model_bodies:{name}"] for r in ranks]


def test_pp_hybrid_train_batch(eight):
    ref, ranks = eight
    res = _leg(ranks, "body_pp_hybrid")
    assert sorted({(r["stage"], r["mp"]) for r in res}) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in res:
        assert math.isfinite(r["loss"])
        np.testing.assert_allclose(r["loss"], ref["pp_loss"], rtol=1e-5)
        assert r["tied_group"] is not None and len(r["tied_group"]) == 2
    # each stage holds its own layers: the two stages' keys differ
    keys = {r["stage"]: tuple(r["keys"]) for r in res}
    assert keys[0] != keys[1]


def test_ep_train_step(eight):
    ref, ranks = eight
    res = _leg(ranks, "body_ep_dryrun")
    assert all(d == 0 for r in res for d in r["dropped"])
    assert all(d == 0 for d in ref["ep"]["drops"])
    mean = float(np.mean([r["losses"][0] for r in res]))
    assert math.isfinite(mean)
    np.testing.assert_allclose(mean, ref["ep"]["losses"][0], rtol=1e-5)


def test_llama_zero3_shards_and_trajectory(eight):
    ref, ranks = eight
    for r in _leg(ranks, "body_llama_zero3"):
        assert r["fracs"]
        for k, f in r["fracs"].items():
            assert abs(f - 1.0 / WORLD) < 1e-9, (k, f)
        err = max(abs(a - b) for a, b in zip(r["losses"],
                                              ref["zero_losses"]))
        assert err < 5e-4, (r["losses"], ref["zero_losses"])


def test_ring_attention_at_16k(eight):
    ref, ranks = eight
    res = _leg(ranks, "body_ring_16k")
    assert all(r["shape"] == (1, RING["S"] // WORLD, RING["H"], RING["D"])
               for r in res)
    got = res[-1]["last"]
    assert np.abs(got - ref["ring"]).max() < 2e-4


# ------------------------------------------------------------- serving tp
FLEET_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                 num_kv_heads=2, max_position=64, dropout=0.0)
FLEET_KW = dict(max_slots=2, prefill_chunk=4, decode_steps=2,
                max_new_tokens=5, max_seq_len=16)
# f32 pools: a bf16 pool's rounding differs between one rank and two
FLEET_POOL = dict(block_size=8, num_blocks=24, dtype="float32")
FLEET_WANTS = [3, 5, 2, 4, 3, 5, 2, 4]


def FLEET_PROMPTS():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 128, n).astype(np.int64)
            for n in (5, 9, 3, 7, 4, 6, 8, 5)]


@pytest.fixture(scope="module")
def four():
    torch_threads = one_torch_thread()
    next(torch_threads)
    try:
        with paddle.utils.unique_name.guard():
            paddle.seed(7)
            jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**FLEET_CFG))
        state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
        prompts, wants = FLEET_PROMPTS(), FLEET_WANTS
        tm = from_paddle_tpu_state(state, GPTConfig(**FLEET_CFG),
                                   device="cpu")
        tm.eval()
        pred = continuous(tm, kv_cache=PagedKVCache(
            2, 2, 16, device="cpu", **FLEET_POOL), **FLEET_KW)
        try:
            refs = [np.asarray(pred.infer(p, timeout=300, max_new_tokens=w))
                    for p, w in zip(prompts, wants)]
        finally:
            pred.close()
    finally:
        next(torch_threads, None)
    ranks = dist_ranks.run_ranks(
        ["dist_model_bodies:body_serving_tp"], 4,
        {"fleet": {"config": FLEET_CFG, "state": state, "prompts": prompts,
                   "wants": wants, "sched_kw": FLEET_KW,
                   "pool": FLEET_POOL}}, deadline_s=240)
    return refs, [r["dist_model_bodies:body_serving_tp"] for r in ranks]


def test_serving_tp_fleet_matches_single_rank(four):
    """Every request token-identical to the single-rank scheduler, as
    JAX's leg asserts (the f32 pools keep tp 1 and tp 2 within f32
    rounding of each other)."""
    refs, ranks = four
    got = ranks[0]["tokens"]
    assert len(got) == len(refs)
    for g, r in zip(got, refs):
        np.testing.assert_array_equal(g, r)


def test_serving_tp_pools_are_head_sharded(four):
    _, ranks = four
    r0 = ranks[0]
    assert r0["kinds"] == ["ContinuousGenerateBatchingPredictor",
                           "_RemoteReplica"]
    for sharded, per_rank, logical in r0["pools"]:
        assert sharded
        assert abs(per_rank / logical - 0.5) < 1e-9


def test_serving_tp_replicas_end_ready(four):
    _, ranks = four
    assert set(ranks[0]["states"].values()) == {"ready"}
    assert all(r["refuses"] for r in ranks[1:])


@pytest.fixture(scope="module")
def fake_decode_surface():
    """The decode step's comms surface at tp 2 over the fake backend, in
    this process (no rank)."""
    from paddle_tpu_torch.analysis.comms import step_comms_surfaces

    (s,) = step_comms_surfaces(paths=("decode_step",), device="cpu")
    return s


def test_serving_tp_decode_comms_on_real_ranks(four, fake_decode_surface):
    """``__graft_entry__.py:486-501``: on every gloo rank the decode
    step's comms report has no HIGH finding (the dp axis visibly
    allowlisted), and its surface is the fake backend's: the same
    collectives, groups of two, the same layouts. Only the mesh differs:
    four ranks make dp 2."""
    _, ranks = four
    fake = fake_decode_surface
    want_ops = [(op.kind, op.result, op.group_size, op.count, op.wire_bytes)
                for op in fake["ops"]]
    assert want_ops
    for r in ranks:
        c = r["comms"]
        assert c["high"] == []
        assert c["suppressed"] == ["dead-mesh-axis"]
        assert [tuple(op) for op in c["ops"]] == want_ops
        assert c["input_specs"] == fake["input_specs"]
        assert c["output_specs"] == fake["output_specs"]
        assert c["mesh_axes"] == {"dp": 2, "tp": 2}


def test_serving_tp_retires_a_remote_replica(four):
    """Retiring the replica led by rank 2 drains and closes it over rpc:
    it reads dead, and the router serves the next request from r0."""
    refs, ranks = four
    r0 = ranks[0]
    assert r0["after_retire"] == {"r0": "ready", "r1": "dead"}
    np.testing.assert_array_equal(r0["after_retire_tokens"], refs[0])
