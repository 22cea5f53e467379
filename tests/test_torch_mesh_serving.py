"""Tensor-parallel paged serving on two gloo ranks against the JAX package
under ``serving_mesh(dp=1, tp=2)`` (``tests/test_mesh_serving.py:62-113``).

The ranks (``dist_ranks.body_mesh_serving``, once per module) load the JAX
model's weights (numpy through ``bridge.py``, each rank its shards) under
``serving_mesh(dp=1, tp=2)`` and decode the JAX test's prompts with
``generate_paged`` over f32 pools. Held:

* greedy tokens identical to JAX's tp = 2 run and to the port's tp = 1 run
  of the same weights;
* sampled tokens (temperature 0.8, top-k 40, seed 123) the same on both
  ranks and the same as the port's tp = 1 run (the uniforms come from the
  seed; ``jax.random`` draws others, so JAX's sampled tokens are not the
  reference), and not all greedy;
* the first sampled token of one prompt in 400 rows (temperature 0.9,
  top-k 6) held to the cut-softmax law of JAX's logits by the chi-square
  pin of ``tests/test_speculative.py`` (df 5, below 25), and the same
  tokens on both ranks;
* each rank's pool is ``[Hkv / 2, P, BS, D]``: exactly half the logical
  pool's bytes, which ``paddle_kv_pool_per_chip_bytes`` reads;
* the continuous scheduler on both ranks in lockstep: rank 0's sequences
  identical to JAX's continuous scheduler (f32 pool, ``decode_kernel=
  "xla"``) on the same prompts; rank 1 refuses requests and ran every
  step program rank 0 sent.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed.mesh import get_mesh, serving_mesh, set_mesh
from paddle_tpu.inference.kv_cache import PagedKVCache as JaxPagedKVCache
from paddle_tpu.inference.scheduler import (
    ContinuousGenerateBatchingPredictor as JaxContinuous,
)
from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM

import dist_ranks

CONFIG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_kv_heads=2, max_position=64, dropout=0.0)
NEW = 5
SAMPLED = dict(temperature=0.8, top_k=40, seed=123)
CHI = dict(prompt=np.array([7, 3, 7, 3, 1, 0], np.int64), n=400, T=0.9,
           top_k=6, seed=0)
SCHED = dict(max_slots=2, prefill_chunk=4, decode_steps=2, max_new_tokens=3,
             block_size=8, num_blocks=16, max_seq_len=16)


def _cut_probs(logits, temperature, top_k):
    """The sampler's law: softmax of logits / temperature over the top k
    (``tests/test_speculative.py``)."""
    scaled = np.asarray(logits, np.float64) / temperature
    kth = np.sort(scaled)[-top_k]
    scaled = np.where(scaled < kth, -np.inf, scaled)
    e = np.exp(scaled - scaled.max())
    return e / e.sum()


def _chi_square(counts, probs, n):
    support = probs > 0
    exp = probs[support] * n
    obs = counts[support]
    assert counts[~support].sum() == 0, "sampled outside the top-k support"
    return float(((obs - exp) ** 2 / exp).sum())


def _small_gpt():
    with paddle.utils.unique_name.guard():
        paddle.seed(7)
        m = GPTForCausalLM(GPTConfig(**CONFIG))
    m.eval()
    return m


def _paged_tokens(m, prompts):
    cache = JaxPagedKVCache(2, 2, 16, block_size=8, num_blocks=24,
                            dtype="float32")
    plens = np.asarray([len(p) for p in prompts])
    batch = np.zeros((len(prompts), int(plens.max())), np.int64)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    nb = max(cache.blocks_for(int(p) + NEW) for p in plens)
    for i in range(len(prompts)):
        cache.reserve(i, int(plens[i]) + NEW)
    tbl = np.stack([cache.block_table(i, pad_to=nb)
                    for i in range(len(prompts))])
    return np.asarray(m.generate_paged(batch, plens, cache, tbl,
                                       max_new_tokens=NEW,
                                       decode_kernel="xla")._value), cache


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n).astype("int64") for n in (5, 9, 3)]
    sched_prompts = [np.array([5, 9, 2, 11], np.int64),
                     rng.integers(0, 128, 7).astype("int64")]
    m = _small_gpt()
    state = {k: np.asarray(v) for k, v in m.gpt.raw_state().items()}
    kw = {k: v for k, v in SCHED.items()
          if k not in ("block_size", "num_blocks")}
    jkv = JaxPagedKVCache(2, 2, 16, block_size=8, num_blocks=16,
                          dtype="float32")
    jgp = JaxContinuous(m, kv_cache=jkv, decode_kernel="xla", **kw)
    try:
        ref_sched = [np.asarray(jgp.infer(p, timeout=60))
                     for p in sched_prompts]
    finally:
        jgp.close()
    prev = get_mesh()
    serving_mesh(dp=1, tp=2)
    try:
        m2 = _small_gpt()
        ref_greedy, jcache = _paged_tokens(m2, prompts)
        jax_bytes = (jcache.pool_bytes(), jcache.per_chip_pool_bytes())
    finally:
        set_mesh(prev)
    logits = np.asarray(m(paddle.to_tensor(CHI["prompt"][None]))._value)
    chi_law = _cut_probs(logits[0, -1], CHI["T"], CHI["top_k"])
    inputs = {"config": CONFIG, "state": state, "prompts": prompts,
              "new": NEW, "sampled": SAMPLED, "sched_kw": SCHED,
              "sched_prompts": sched_prompts, "chi": CHI}
    ranks = dist_ranks.run_ranks(["body_mesh_serving"], 2, inputs)
    return (ref_greedy, ref_sched, jax_bytes, sched_prompts,
            [r["body_mesh_serving"] for r in ranks], chi_law)


def test_tp_greedy_tokens_match_jax_and_tp1(setup):
    ref_greedy, _, _, _, ranks, _ = setup
    for r in ranks:
        assert r["tp"] == 2
        np.testing.assert_array_equal(r["greedy"], ref_greedy)
        np.testing.assert_array_equal(r["tp1_greedy"], ref_greedy)


def test_tp_sampled_tokens_same_on_every_rank(setup):
    _, _, _, _, ranks, _ = setup
    np.testing.assert_array_equal(ranks[0]["sampled"], ranks[1]["sampled"])
    for r in ranks:
        np.testing.assert_array_equal(r["sampled"], r["tp1_sampled"])
    assert not np.array_equal(ranks[0]["sampled"], ranks[0]["greedy"])


def test_tp_pool_holds_half_the_bytes(setup):
    _, _, jax_bytes, _, ranks, _ = setup
    for r in ranks:
        sharded, shape, per_chip, logical, tp1_bytes = r["pool"]
        assert sharded and not r["tp1_sharded"]
        assert shape == (1, 25, 8, 16)          # Hkv / 2, pages + scratch
        assert per_chip * 2 == logical == tp1_bytes
        assert r["sched_pool"] == (1, 17, 8, 16)
        assert r["per_chip_gauge"] == [float(r["sched_pool_bytes"])]
    # JAX's pool: the same halving (its pool has no scratch page)
    assert jax_bytes[1] * 2 == jax_bytes[0]


def test_tp_continuous_scheduler_in_lockstep(setup):
    _, ref_sched, _, prompts, ranks, _ = setup
    for i, (got, want) in enumerate(zip(ranks[0]["sched"], ref_sched)):
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")
        assert len(got) == len(prompts[i]) + SCHED["max_new_tokens"]
    assert ranks[1]["follower_refuses"]
    assert ranks[1]["follower_runs"] > 0


def test_tp_sampled_first_token_law_chi_square(setup):
    """tp = 2 sampling draws from the cut-softmax law of the model's
    logits: 400 first tokens chi-square against JAX's law (df 5; 25 is
    p < 1e-3, the pin of ``tests/test_speculative.py``), every rank the
    same tokens."""
    *_, ranks, law = setup
    np.testing.assert_array_equal(ranks[0]["chi_tokens"],
                                  ranks[1]["chi_tokens"])
    counts = np.bincount(ranks[0]["chi_tokens"], minlength=law.size)
    assert _chi_square(counts, law, CHI["n"]) < 25.0
