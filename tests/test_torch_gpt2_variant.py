"""The GPT-2-style branches of the port's GPT (learned positions,
LayerNorm, GELU with biases, an untied ``lm_head``; ``gpt3_1p3b``'s
family) held against the JAX package on the CPU, in f32, with JAX's
weights carried over by ``bridge.py``. The configurations are the three of
JAX's ``tests/test_gpt_generate.py`` (the default RoPE / RMSNorm / SwiGLU,
the GPT-2 style, GQA) and the GPT-2 style with an untied head.

Tolerances (f32 sums in another order, as in the GPT parity tests):
logits within 1e-5 absolute, the loss within 1e-6 relative, gradients
within 5e-5; paged logits within 1e-4 of JAX's ``decode_kernel="xla"`` step
path. Greedy tokens are compared after a top-1 / top-2 logit margin of
1e-3 is asserted on the port's forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.autograd import tape
from paddle_tpu.inference.kv_cache import PagedKVCache as JaxPagedKVCache
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.inference import (
    ContinuousGenerateBatchingPredictor,
    PagedKVCache,
)
from paddle_tpu_torch.models import gpt as tgpt

BASE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position=64, dropout=0.0)
GPT2 = dict(use_rope=False, use_rms_norm=False, use_swiglu=False)
CONFIGS = {"rope_rms_swiglu": {}, "gpt2": GPT2, "gqa": dict(num_kv_heads=2),
           "gpt2_untied": dict(GPT2, tie_embeddings=False)}
MARGIN = 1e-3


def _pair(name, seed=7):
    kw = dict(BASE, **CONFIGS[name])
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**kw))
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    return jm, from_paddle_tpu_state(state, tgpt.GPTConfig(**kw),
                                     device="cpu")


def _eval_pair(name):
    jm, tm = _pair(name)
    jm.eval()
    tm.eval()
    return jm, tm


def test_gpt2_parameters_are_jax_names():
    jm, tm = _pair("gpt2_untied")
    names = {k for k, _ in tm.named_parameters()}
    assert names == set(jm.state_dict())
    for k in ("gpt.embed_positions.weight", "gpt.lm_head.weight",
              "gpt.blocks.0.ln1.bias", "gpt.blocks.0.mlp.fc1.bias",
              "gpt.blocks.0.mlp.down.bias", "gpt.blocks.0.attn.qkv_proj.bias",
              "gpt.blocks.0.attn.out_proj.bias", "gpt.ln_f.bias"):
        assert k in names, k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_loss_and_gradients_match_jax(name):
    jm, tm = _pair(name)
    ids = np.random.default_rng(0).integers(0, 128, (2, 20))
    labels = np.roll(ids, -1, axis=1)

    def f(state, x, y):
        with tape.no_grad():
            logits, loss = jm.functional_call(state, paddle.Tensor(x),
                                              labels=paddle.Tensor(y))
        return loss._value, logits._value

    state = {k: v._value for k, v in jm.state_dict().items()}
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(state, ids, labels)
    logits, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    grads = dict(tm.named_parameters())
    assert set(grads) == set(jgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k].grad.numpy(), np.asarray(g),
                                   atol=5e-5, rtol=5e-5, err_msg=k)


@torch.no_grad()
def _cachefree_greedy(tm, ids, n):
    """Greedy tokens of the port's cache-free forward, each pick's top-1 /
    top-2 margin asserted above MARGIN."""
    ids = torch.as_tensor(ids)
    for _ in range(n):
        top2 = tm(ids)[:, -1].topk(2, dim=-1)
        gap = top2.values[:, 0] - top2.values[:, 1]
        assert bool((gap > MARGIN).all()), f"near-tie: {gap.min()}"
        ids = torch.cat([ids, top2.indices[:, :1]], dim=1)
    return ids.numpy()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cached_decode_matches_cachefree_greedy_and_jax(name):
    """JAX ``test_cached_decode_matches_cachefree_greedy``'s check on the
    port, and the tokens of JAX's generate()."""
    jm, tm = _eval_pair(name)
    prompt = np.random.default_rng(0).integers(0, 128, (2, 5))
    want = _cachefree_greedy(tm, prompt, 6)
    got = tm.generate(prompt, max_new_tokens=6, dtype=None).numpy()
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jm.generate(paddle.to_tensor(prompt), max_new_tokens=6,
                                 dtype=None, decode_kernel="xla")._value)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["gpt2", "rope_rms_swiglu"])
def test_decode_validate_raises_where_jax_raises(name):
    """Learned positions: prompt + new tokens past ``max_position`` (64)
    raise in JAX's hook and in the port's generate(), generate_paged(),
    the scheduler's admission and generate_speculative, before any
    forward; RoPE models serve the same request."""
    jm, tm = _eval_pair(name)
    prompt = np.arange(60, dtype=np.int64) % 128
    learned = name == "gpt2"
    if learned:
        with pytest.raises(ValueError, match="max_position"):
            jm._decode_validate(60, 5)
        jm._decode_validate(60, 4)
    else:
        jm._decode_validate(60, 5)
    kv, pool = (PagedKVCache(*tm._decode_cache_spec(), block_size=8,
                             num_blocks=9, dtype=torch.float32, device="cpu")
                for _ in range(2))
    gp = ContinuousGenerateBatchingPredictor(
        tm, kv_cache=pool, max_slots=1, prefill_chunk=16, decode_steps=2,
        max_new_tokens=5, max_seq_len=72, device="cpu")
    tables = kv.reserve("x", 65)[None]
    calls = (
        lambda: tm.generate(prompt[None], max_new_tokens=5, dtype=None),
        lambda: tm.generate_paged(prompt[None], [60], kv, tables,
                                  max_new_tokens=5),
        lambda: gp.infer(prompt, timeout=60),
        lambda: tm.generate_speculative(prompt, max_new_tokens=5, spec_k=2,
                                        dtype=None))
    try:
        for call in calls:
            if learned:
                with pytest.raises(ValueError, match="max_position"):
                    call()
            else:
                assert np.asarray(call()).shape[-1] in (5, 65)
    finally:
        gp.close()
    tm._decode_validate(60, 4)
    assert tm.generate(prompt[None], max_new_tokens=4,
                       dtype=None).shape == (1, 64)


def test_paged_rows_past_the_table_are_clipped_as_jax_clips():
    """A chunk whose rows run past ``max_position`` (a padding slot at
    offset 60 with C = 8, and the live slot's own padding rows): positions
    clip into the table, as JAX's paged branch clips them, so the live
    rows' logits match JAX's (1e-4) and no index leaves the table (on CPU
    an index past it raises)."""
    jm, tm = _eval_pair("gpt2")
    C = 8
    chunk = np.random.default_rng(2).integers(0, 128, (2, C))
    offs = np.array([58, 60])
    lens = np.array([3, 0])
    spec = jm._decode_cache_spec()
    jkv = JaxPagedKVCache(*spec, block_size=8, num_blocks=20,
                          dtype="float32")
    tkv = PagedKVCache(*spec, block_size=8, num_blocks=20,
                       dtype=torch.float32, device="cpu")
    tables = [np.stack([kv.reserve(i, 72) for i in range(2)])
              for kv in (jkv, tkv)]
    valid = np.arange(C)[None, :] < lens[:, None]
    logits, _ = jax.jit(lambda st, ids, caches, o, t, v: jm._decode_call(
        st, ids, caches, o, "xla", paged_tables=t, cache_valid=v))(
        jm.model_state_raw(), jnp.asarray(chunk),
        list(zip(jkv.k_pages, jkv.v_pages)), jnp.asarray(offs, jnp.int32),
        jnp.asarray(tables[0], jnp.int32), jnp.asarray(valid))
    want = np.asarray(logits)[0, lens[0] - 1]
    got = tm.chunk_logits(chunk, offs, lens, tkv, tables[1]).numpy()[0]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    with pytest.raises(IndexError):     # the unclipped lookup would fail
        tm.gpt.embed_positions(torch.as_tensor(offs[:, None] + np.arange(C)))


def test_o2_leaves_layer_norm_in_f32_and_casts_the_rest_as_jax():
    jm, tm = _pair("gpt2_untied")
    jopt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                  parameters=jm.parameters())
    opt = topt.AdamW(learning_rate=1e-4, parameters=tm.parameters())
    paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    tamp.decorate(tm, opt, level="O2", dtype="bfloat16")
    want = {k: str(v.dtype) for k, v in jm.state_dict().items()}
    got = {k: str(p.dtype).replace("torch.", "")
           for k, p in tm.named_parameters()}
    assert got == want
    f32 = {k for k, d in got.items() if d == "float32"}
    assert f32 == {k for k in got if ".ln" in k}
    assert {d for k, d in got.items() if k not in f32} == {"bfloat16"}
    logits, loss = tm(torch.zeros((1, 4), dtype=torch.int64),
                      labels=torch.zeros((1, 4), dtype=torch.int64))
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(loss))


def test_generate_paged_validates_the_longest_prompt_not_the_padding():
    """The whole-batch predictor pads P to a power of two: a 50-token
    prompt padded to 64 with 10 new tokens fits the 64-row table and is
    served (the padded rows' positions clip); 55 + 10 does not."""
    _, tm = _eval_pair("gpt2")
    kv = PagedKVCache(*tm._decode_cache_spec(), block_size=8, num_blocks=9,
                      dtype=torch.float32, device="cpu")
    ids = np.zeros((1, 64), np.int64)
    ids[0, :55] = np.arange(55) % 128
    tables = kv.reserve("x", 72)[None]
    out = tm.generate_paged(ids, [50], kv, tables, max_new_tokens=10)
    assert np.asarray(out).shape == (1, 10)
    with pytest.raises(ValueError, match="max_position"):
        tm.generate_paged(ids, [55], kv, tables, max_new_tokens=10)
