"""Tensor parallelism of the port's LLaMA and BERT, and LoRA and the
self-drafter under a tensor-parallel scheduler, on four gloo ranks
against the JAX package.

* Training at ``[dp 2, mp 2]`` (``fleet.init``): ``llama_tiny()`` and
  ``bert_tiny()`` masked-LM, each rank its shards of JAX's whole weights
  (``bridge.shard_state``: q/k/v/gate/up and lm_head in columns, o/down
  in rows; BERT's qkv per head group, fc1 and transform in columns,
  out and fc2 in rows; the embeddings in vocab rows) and its dp half of
  the batch, 3 AdamW steps of ``TrainStep`` through fleet's model and
  optimizer: the dp-averaged losses within 1e-5 relative of JAX's
  single-device TrainStep on the whole batch. The MLM batch masks the
  same number of positions in every row (the dp mean weights ranks by
  rows; JAX's loss is the mean over masked positions).
* LLaMA serving at tp 2 (``serving_mesh(dp=2, tp=2)``: each pair of ranks
  a group): greedy ``generate_paged`` on the head-sharded pool ``[Hkv /
  2, P, BS, D]``, tokens identical to JAX's greedy decode on the same
  weights up to each prompt's first near-tie (a top-2 logit gap under
  ``serving_port.MARGIN`` on the port's whole model). JAX's dense
  ``generate()`` is the reference: its ``generate_paged`` writes the first
  decode row one position late (ROADMAP C, reference side) and departs
  from its own dense decode on these prompts after the first new token.
* LoRA at tp 2: two adapters, mixed base / adapter requests through the
  continuous scheduler, targets ``qkv_proj`` / ``gate_up`` (column:
  B cut) and ``out_proj`` (row: A cut, delta before the all-reduce);
  tokens identical to the single-rank port and to JAX's LoRA scheduler on
  the same factors; an unload and a reload on the leader reach the
  follower's registry, which then serves the same tokens.
* The self-drafter at tp 2: greedy speculative decoding (``spec_k`` 3,
  f32 drafts) whose draft calls go through the lockstep; tokens and the
  drafted / accepted counts equal the single-rank port's.

All bodies run in one spawn of four ranks.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.adapters import AdapterRegistry as JaxRegistry
from paddle_tpu.inference.scheduler import (
    ContinuousGenerateBatchingPredictor as JaxContinuous,
)
from paddle_tpu.jit.train import TrainStep as JaxTrainStep
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.inference import AdapterRegistry, PagedKVCache
from paddle_tpu.inference.kv_cache import PagedKVCache as JaxPagedKVCache
from paddle_tpu_torch.inference.speculative import SelfSpeculativeDrafter
from paddle_tpu_torch.models.llama import LlamaConfig

import dist_ranks
from serving_port import (
    MARGIN,
    assert_margins,
    continuous,
    jax_gpt,
    one_torch_thread,
    port_of,
)

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)
# the schedulers run over f32 pools (a bf16 pool's rounding moves logits
# by more than the margin guard allows for)
SCHED = dict(max_slots=4, prefill_chunk=4, decode_steps=2, max_new_tokens=6,
             max_seq_len=40)
POOL = dict(block_size=8, num_blocks=32, dtype="float32")
TARGETS = ("qkv_proj", "gate_up", "out_proj")
ALPHA = 8.0


def _cfg_dict(c):
    return {k: v for k, v in vars(c).items() if not k.startswith("_")}


def _jax_train(model, ids, labels):
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
    step = JaxTrainStep(model, lambda logits, loss: loss, opt)
    return [float(step(paddle.to_tensor(ids), paddle.to_tensor(labels)))
            for _ in range(3)]


def _llama_train():
    cfg = jllama.llama_tiny()
    with paddle.utils.unique_name.guard():
        paddle.seed(0)
        jm = jllama.LlamaForCausalLM(cfg)
    state = {k: np.asarray(v) for k, v in jm.raw_state().items()}
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (4, 16)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    case = {"config": _cfg_dict(cfg), "state": state, "ids": ids,
            "labels": labels}
    return case, _jax_train(jm, ids, labels)


def _bert_train():
    cfg = jbert.bert_tiny()
    with paddle.utils.unique_name.guard():
        paddle.seed(1)
        jm = jbert.BertForMaskedLM(cfg)
    state = {k: np.asarray(v) for k, v in jm.raw_state().items()}
    rs = np.random.RandomState(1)
    ids = rs.randint(5, cfg.vocab_size, (4, 16)).astype(np.int64)
    # two masked positions in every row: the same count on each dp rank
    labels = np.full_like(ids, -100)
    masked = ids.copy()
    for r in range(ids.shape[0]):
        pos = rs.permutation(ids.shape[1])[:2]
        labels[r, pos] = ids[r, pos]
        masked[r, pos] = 3
    case = {"config": _cfg_dict(cfg), "state": state, "ids": masked,
            "labels": labels}
    return case, _jax_train(jm, masked, labels)


def _llama_serve():
    cfg = jllama.LlamaConfig(vocab_size=128, hidden_size=64, num_layers=2,
                             num_heads=4, num_kv_heads=2,
                             intermediate_size=128, max_position=64)
    with paddle.utils.unique_name.guard():
        paddle.seed(3)
        jm = jllama.LlamaForCausalLM(cfg)
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.raw_state().items()}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, n).astype("int64") for n in (5, 9, 3)]
    new = 5
    # JAX's dense greedy generate(): its generate_paged writes the first
    # decode row one position late (ROADMAP C, reference side) and so
    # departs from its own dense decode after the first new token
    toks = np.stack([np.asarray(jm.generate(
        paddle.to_tensor(p[None]), max_new_tokens=new, dtype=None,
        decode_kernel="xla")._value)[0, len(p):] for p in prompts])
    # the port's whole model guards the comparison against near-ties:
    # each prompt's tokens are compared up to its first position whose
    # top-2 logit gap is under MARGIN
    whole = from_paddle_tpu_state(state, LlamaConfig(**_cfg_dict(cfg)),
                                  device="cpu")
    whole.eval()
    decided = [_decided(whole, p, t) for p, t in zip(prompts, toks)]
    assert sum(decided) >= 2 * new
    return {"config": _cfg_dict(cfg), "state": state, "prompts": prompts,
            "new": new}, (toks, decided)


def _decided(model, prompt, new_toks):
    """How many leading new tokens the forward decides by a gap above
    MARGIN (a near-tie could round either way across packages)."""
    import torch

    with torch.no_grad():
        ids = torch.as_tensor(np.concatenate([prompt, new_toks]))[None]
        lg = model(ids).float()[0, len(prompt) - 1:-1]
    top2 = lg.topk(2, dim=-1).values
    ok = (top2[:, 0] - top2[:, 1] > MARGIN).tolist()
    return ok.index(False) if False in ok else len(ok)


def _pool(tm):
    L, Hkv, D = tm._decode_cache_spec()
    return PagedKVCache(L, Hkv, D, device="cpu", **POOL)


def _lora_weights(reg, seed, rank=4, scale=0.1):
    rs = np.random.RandomState(seed)
    return {p: (rs.randn(reg.dims(p)[0], rank).astype(np.float32) * scale,
                rs.randn(rank, reg.dims(p)[1]).astype(np.float32) * scale)
            for p in reg.target_paths()}


def _lora():
    jm, cfg = jax_gpt(11, vocab=160)
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    tm = port_of(jm, cfg)
    reg = AdapterRegistry(tm, max_adapters=2, max_rank=8, targets=TARGETS)
    weights = {"a1": _lora_weights(reg, 7), "a2": _lora_weights(reg, 8)}
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, 160, n).astype("int64")
               for n in (3, 7, 5, 9, 4, 6)]
    requests = list(zip(prompts, [None, "a1", "a2", "a1", None, "a2"]))
    # the single-rank port
    for name, w in weights.items():
        reg.register(name, w, alpha=ALPHA)
    pred = continuous(tm, adapters=reg, kv_cache=_pool(tm), **SCHED)
    try:
        port = [np.asarray(pred.infer(p, timeout=300, adapter=a))
                for p, a in requests]
    finally:
        pred.close()
        reg.close()
    # JAX's LoRA scheduler on the same factors
    jreg = JaxRegistry(jm, max_adapters=2, max_rank=8, targets=TARGETS)
    for name, w in weights.items():
        jreg.register(name, w, alpha=ALPHA)
    jp = JaxContinuous(jm, adapters=jreg, decode_kernel="xla",
                       kv_cache=JaxPagedKVCache(2, 2, 16, **POOL), **SCHED)
    try:
        ref = [np.asarray(jp.infer(p, timeout=300, adapter=a))
               for p, a in requests]
    finally:
        jp.close()
        jreg.close()
    # the margin guard on the merged models
    merged = {None: tm}
    for name, w in weights.items():
        delta = {}
        for path, (a, b) in w.items():
            suffix = ".".join(path.split(".")[-3:]) + ".weight"
            delta[suffix] = (a @ b) * (ALPHA / a.shape[1])
        merged[name] = port_of(jm, cfg, delta)
    for (p, a), seq in zip(requests, ref):
        assert_margins(merged[a].eval(), seq, len(p))
    case = {"config": cfg, "state": state, "targets": TARGETS,
            "weights": weights, "alpha": ALPHA, "requests": requests,
            "sched_kw": SCHED, "pool": POOL}
    return case, port, ref


def _spec():
    jm, cfg = jax_gpt(13, vocab=160)
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    tm = port_of(jm, cfg).eval()
    rng = np.random.default_rng(31)
    # repetitive prompts, so drafts are accepted and rejected
    prompts = [np.tile(rng.integers(0, 160, 3), 4).astype("int64")
               for _ in range(3)]
    kw = dict(SCHED, spec_k=3)
    pred = continuous(tm, drafter=SelfSpeculativeDrafter(tm, dtype=None),
                      kv_cache=_pool(tm), **kw)
    try:
        toks = [np.asarray(pred.infer(p, timeout=300)) for p in prompts]
        counts = (pred._spec_drafted, pred._spec_accepted)
    finally:
        pred.close()
    for p, t in zip(prompts, toks):
        assert_margins(tm, t, len(p))
    return {"config": cfg, "state": state, "prompts": prompts,
            "sched_kw": kw, "pool": POOL}, toks, counts


@pytest.fixture(scope="module")
def setup():
    llama_train, llama_losses = _llama_train()
    bert_train, bert_losses = _bert_train()
    llama_serve, llama_toks = _llama_serve()
    lora, lora_port, lora_jax = _lora()
    spec, spec_toks, spec_counts = _spec()
    ref = {"llama_losses": llama_losses, "bert_losses": bert_losses,
           "llama_toks": llama_toks, "lora_port": lora_port,
           "lora_jax": lora_jax, "spec_toks": spec_toks,
           "spec_counts": spec_counts}
    ranks = dist_ranks.run_ranks(
        ["dist_model_bodies:body_tp_serving",
         "dist_model_bodies:body_tp_training"], 4,
        {"llama_train": llama_train, "bert_train": bert_train,
         "llama_serve": llama_serve, "lora": lora, "spec": spec},
        deadline_s=240)
    return ref, [(r["dist_model_bodies:body_tp_serving"],
                  r["dist_model_bodies:body_tp_training"]) for r in ranks]


@pytest.mark.parametrize("model", ["llama", "bert"])
def test_tp_training_matches_jax_single_device(setup, model):
    ref, ranks = setup
    for _, train in ranks:
        res = train[model]
        assert res["tp"] == 2
        np.testing.assert_allclose(res["losses"], ref[f"{model}_losses"],
                                   rtol=1e-5)


def test_tp_logits_are_the_rank_vocab_columns(setup):
    _, ranks = setup
    for _, train in ranks:
        assert train["llama"]["local_vocab"] == 512 // 2
        assert train["bert"]["local_vocab"] == 512 // 2


def test_llama_tp_serving_tokens_match_jax(setup):
    ref, ranks = setup
    for serve, _ in ranks:
        res = serve["llama"]
        assert res["tp"] == 2 and res["pool"][0] == 2 // 2
        assert abs(res["ratio"] - 0.5) < 1e-12
        toks, decided = ref["llama_toks"]
        got = res["tokens"][:, -toks.shape[1]:]
        for g, want, n in zip(got, toks, decided):
            np.testing.assert_array_equal(g[:n], want[:n])


def test_lora_at_tp2_matches_single_rank_and_jax(setup):
    ref, ranks = setup
    for (p, j) in zip(ref["lora_port"], ref["lora_jax"]):
        np.testing.assert_array_equal(p, j)
    for serve, _ in ranks:
        lora = serve["lora"]
        if "tokens" not in lora:
            continue
        for got, want in zip(lora["tokens"], ref["lora_port"]):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(lora["again"], ref["lora_port"][:3]):
            np.testing.assert_array_equal(got, want)


def test_lora_loads_and_unloads_reach_the_followers(setup):
    """Every rank's registry ends with the same names, the whole
    projection's dims, and its own cut of the factors in the bank."""
    _, ranks = setup
    names = {tuple(serve["lora"]["names"]) for serve, _ in ranks}
    assert names == {("a1", "a2")}
    for serve, _ in ranks:
        lora = serve["lora"]
        for path, (a, b) in lora["bank"].items():
            assert np.abs(a[1:]).sum() > 0 and np.abs(b[1:]).sum() > 0
            din, dout = lora["dims"][path]
            if path.endswith("out_proj"):
                assert a.shape[1] == din // 2 and b.shape[2] == dout
            else:
                assert a.shape[1] == din and b.shape[2] == dout // 2


def test_self_drafter_at_tp2_matches_single_rank(setup):
    ref, ranks = setup
    for serve, _ in ranks:
        spec = serve["spec"]
        if "tokens" in spec:
            for got, want in zip(spec["tokens"], ref["spec_toks"]):
                np.testing.assert_array_equal(got, want)
            assert (spec["drafted"], spec["accepted"]) == ref["spec_counts"]
            assert spec["drafted"] > 0
        else:
            # the follower ran the drafts' generate calls too
            assert spec["follower_runs"] > 0


def test_llama_tp_refuses_a_tp_that_does_not_divide_the_kv_heads():
    """GQA groups stay whole: tp must divide the kv heads (and the heads,
    the MLP width and the vocab), as JAX's paged kernel declines to shard
    otherwise."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    class _Group:
        nranks, rank, ranks, id = 4, 0, [0, 1, 2, 3], -1

    with pytest.raises(ValueError, match="num_kv_heads"):
        LlamaForCausalLM(llama_tiny(), device="cpu", mp_group=_Group())
