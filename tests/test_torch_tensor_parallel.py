"""Tensor-parallel GPT and the TP layers on two gloo ranks against the JAX
package over a ("dp", "mp") mesh of fake CPU devices
(``tests/test_parallel_ce.py:24-51`` for the vocab-parallel loss).

The ranks (``dist_ranks.body_tensor_parallel``, once per module) call
``fleet.init`` with mp = 2 and build the GPT of ``gpt_tiny`` width (and a
GQA variant) from the JAX model's weights, each rank its shards
(``bridge.shard_state``). JAX runs the same model under
``auto_mesh(1, 2, ["dp", "mp"])`` through one jitted ``value_and_grad``.
Held in f32:

* loss and the gathered logits within rtol 1e-5, atol 1e-5;
* the ranks' gradient shards, gathered back to full shape
  (``bridge.gather_state``), within 1e-4 of each gradient's largest
  magnitude;
* a contiguous cut of the fused ``qkv_proj`` (not per head group) gives
  other logits — the cut the bridge must not make;
* three ``TrainStep`` steps of AdamW clipped by the global norm across mp
  (``HybridParallelClipGrad``): losses within rtol 1e-5 and the gathered
  parameters within 1e-5 of JAX's TrainStep;
* over four ranks, dp = 2 x mp = 2 through fleet's ``TensorParallel`` and
  optimizer (``dist_ranks.body_hybrid_dp_mp``, JAX under
  ``auto_mesh(2, 2, ["dp", "mp"])`` on the whole batch): the gradients of
  one backward, synced over dp by the wrapper, and three TrainStep steps
  of SGD (losses within rtol 1e-5, weights within 1e-5);
* ``VocabParallelEmbedding``, ``ColumnParallelLinear(gather_output)``,
  ``RowParallelLinear`` and ``ParallelCrossEntropy`` alone against JAX's
  layers: outputs and gradients.
"""
import numpy as np
import pytest

import jax

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.autograd import tape
from paddle_tpu.distributed.fleet.meta_parallel import (
    ColumnParallelLinear as JCol,
    ParallelCrossEntropy as JCE,
    RowParallelLinear as JRow,
    VocabParallelEmbedding as JEmb,
)
from paddle_tpu.jit.train import TrainStep as JaxTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.bridge import gather_state
from paddle_tpu_torch.models.gpt import GPTConfig

import dist_ranks

CONFIGS = {
    "tiny": dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                 max_position=128),
    "gqa": dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, max_position=128),
}


def _jax_model(name, seed=11):
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        return jgpt.GPTForCausalLM(jgpt.GPTConfig(**CONFIGS[name]))


def _state(jm):
    return {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}


def _loss_and_grads(jm, ids, labels):
    def f(state, x, y):
        with tape.no_grad():
            logits, loss = jm.functional_call(state, paddle.Tensor(x),
                                              labels=paddle.Tensor(y))
        return loss._value, logits._value

    state = {k: v._value for k, v in jm.state_dict().items()}
    (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        state, ids, labels)
    return (np.asarray(logits), float(loss),
            {k: np.asarray(v) for k, v in grads.items()})


def _layers_inputs():
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype("float32")   # noqa: E731
    labels = rng.integers(0, 32, (4, 6))
    labels[0, 0] = -100
    return {"emb_w": f(32, 8), "ids": rng.integers(0, 32, (3, 5)),
            "emb_ct": f(3, 5, 8), "w1": f(16, 32), "b1": f(32),
            "w2": f(32, 16), "b2": f(16), "x": f(2, 5, 16),
            "logits": f(4, 6, 32), "labels": labels}


def _jax_layers(L):
    """JAX's layers with the whole weights: outputs and gradients."""
    out = {}
    T = paddle.to_tensor
    emb = JEmb(32, 8)
    emb.weight.set_value(L["emb_w"])
    e = emb(T(L["ids"]))
    (e * T(L["emb_ct"])).sum().backward()
    out["emb_out"], out["emb_wgrad"] = e.numpy(), np.asarray(emb.weight.grad)
    col, row = JCol(16, 32, gather_output=True), JRow(32, 16)
    col.weight.set_value(L["w1"])
    col.bias.set_value(L["b1"])
    row.weight.set_value(L["w2"])
    row.bias.set_value(L["b2"])
    x = paddle.to_tensor(L["x"], stop_gradient=False)
    y = row(col(x))
    (y ** 2).sum().backward()
    out["mlp_out"], out["mlp_xgrad"] = y.numpy(), np.asarray(x.grad)
    out["mlp_grads"] = [np.asarray(p.grad) for p in
                        (col.weight, col.bias, row.weight, row.bias)]
    lg = paddle.to_tensor(L["logits"], stop_gradient=False)
    loss = JCE(ignore_index=-100)(lg, T(L["labels"]))
    loss.mean().backward()
    out["ce_loss"], out["ce_grad"] = loss.numpy(), np.asarray(lg.grad)
    return out


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1024, (2, 24))
    labels = np.roll(ids, -1, axis=1)
    ref, states = {}, {}
    prev = jdist.get_mesh()
    jdist.set_mesh(jdist.auto_mesh(1, 2, dim_names=["dp", "mp"]))
    try:
        for name in CONFIGS:
            jm = _jax_model(name)
            states[name] = _state(jm)
            ref[name] = _loss_and_grads(jm, ids, labels)
        jm = _jax_model("tiny")
        jopt = paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=jm.parameters(),
            weight_decay=0.01, grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
        jstep = JaxTrainStep(jm, lambda logits, loss: loss, jopt)
        ref["step_losses"] = [float(jstep(paddle.to_tensor(ids),
                                          labels=paddle.to_tensor(labels)))
                              for _ in range(3)]
        ref["step_params"] = _state(jm)
    finally:
        jdist.set_mesh(prev)
    L = _layers_inputs()
    ref["layers"] = _jax_layers(L)
    inputs = {"configs": CONFIGS, "states": states, "ids": ids,
              "labels": labels, "layers": L}
    ranks = dist_ranks.run_ranks(["body_tensor_parallel"], 2, inputs)
    return ref, states, [r["body_tensor_parallel"] for r in ranks]


HYBRID_LR = 0.5


@pytest.fixture(scope="module")
def hybrid():
    """JAX's dp = 2 x mp = 2 run of the tiny GPT on a 4-row batch, and the
    four ranks' run of the same (``body_hybrid_dp_mp``)."""
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1024, (4, 24))
    labels = np.roll(ids, -1, axis=1)
    prev = jdist.get_mesh()
    jdist.set_mesh(jdist.auto_mesh(2, 2, dim_names=["dp", "mp"]))
    try:
        jm = _jax_model("tiny")
        state = _state(jm)
        _, _, grads = _loss_and_grads(jm, ids, labels)
        jopt = paddle.optimizer.SGD(learning_rate=HYBRID_LR,
                                    parameters=jm.parameters())
        jstep = JaxTrainStep(jm, lambda logits, loss: loss, jopt)
        losses = [float(jstep(paddle.to_tensor(ids),
                              labels=paddle.to_tensor(labels)))
                  for _ in range(3)]
        params = _state(jm)
    finally:
        jdist.set_mesh(prev)
    inputs = {"config": CONFIGS["tiny"], "state": state, "ids": ids,
              "labels": labels, "lr": HYBRID_LR}
    ranks = dist_ranks.run_ranks(["body_hybrid_dp_mp"], 4, inputs)
    ref = {"grads": {k.removeprefix("gpt."): v for k, v in grads.items()},
           "losses": losses, "params": params}
    return ref, [r["body_hybrid_dp_mp"] for r in ranks]


def _gathered(ranks, key):
    return gather_state([r[key] for r in ranks],
                        GPTConfig(**CONFIGS["tiny"]))


def test_hybrid_group_layout(setup):
    _, _, ranks = setup
    assert [r["mp_rank"] for r in ranks] == [0, 1]
    assert {r["mp_world"] for r in ranks} == {2}
    assert {r["mode"] for r in ranks} == {"tensor"}
    # pp = 2 over the same two ranks builds (pipeline parallelism, A5.1)
    assert [r["pp_stage"] for r in ranks] == [0, 1]
    assert {r["pp_mode"] for r in ranks} == {"pipeline"}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_gpt_loss_and_logits(setup, name):
    ref, _, ranks = setup
    logits, loss, _ = ref[name]
    for r in ranks:
        assert r[f"{name}_tp_group"] == [0, 1]
        assert r[f"{name}_local_vocab"] == 512       # half the vocab a rank
        np.testing.assert_allclose(r[f"{name}_loss"], loss, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r[f"{name}_logits"], logits, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_gpt_rank_shapes(setup, name):
    """Each rank holds 1/2 of the fused qkv columns: its q heads, then its
    kv heads' keys and values."""
    _, _, ranks = setup
    c = CONFIGS[name]
    d = c["hidden_size"] // c["num_heads"]
    kv = c.get("num_kv_heads", c["num_heads"])
    for r in ranks:
        assert r[f"{name}_qkv_shape"] == (
            c["hidden_size"], (c["num_heads"] + 2 * kv) * d // 2)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_gpt_gathered_gradients(setup, name):
    ref, _, ranks = setup
    cfg = GPTConfig(**CONFIGS[name])
    got = gather_state([r[f"{name}_grads"] for r in ranks], cfg)
    want = {k.removeprefix("gpt."): v for k, v in ref[name][2].items()}
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k]
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=k)


def test_contiguous_qkv_cut_computes_other_logits(setup):
    """The control: the fused qkv columns cut contiguously give rank 0
    all of q and rank 1 the keys and values — the forward runs without an
    error and its logits are wrong."""
    ref, _, ranks = setup
    logits = ref["tiny"][0]
    for r in ranks:
        assert np.abs(r["contiguous_logits"] - logits).max() > 1e-2


def test_tp_train_step_with_hybrid_clip(setup):
    ref, _, ranks = setup
    for r in ranks:
        assert r["clip"] == "HybridParallelClipGrad"
        np.testing.assert_allclose(r["step_losses"], ref["step_losses"],
                                   rtol=1e-5)
    got = _gathered(ranks, "step_params")
    for k, v in got.items():
        np.testing.assert_allclose(v, ref["step_params"][k], atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("what", ["emb", "mlp", "ce"])
def test_tp_layers_match_jax(setup, what):
    ref, _, ranks = setup
    J = ref["layers"]
    for rank, r in enumerate(ranks):
        if what == "emb":
            np.testing.assert_allclose(r["emb_out"], J["emb_out"], rtol=1e-6)
            np.testing.assert_allclose(
                r["emb_wgrad"], np.split(J["emb_wgrad"], 2, 0)[rank],
                rtol=1e-6)
        elif what == "mlp":
            np.testing.assert_allclose(r["mlp_out"], J["mlp_out"],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(r["mlp_xgrad"], J["mlp_xgrad"],
                                       rtol=1e-5, atol=1e-4)
            cw, cb, rw, rb = J["mlp_grads"]
            want = [np.split(cw, 2, 1)[rank], np.split(cb, 2)[rank],
                    np.split(rw, 2, 0)[rank], rb]
            for g, w in zip(r["mlp_grads"], want):
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           atol=1e-4 * np.abs(w).max())
        else:
            np.testing.assert_allclose(r["ce_loss"], J["ce_loss"], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(
                r["ce_grad"], np.split(J["ce_grad"], 2, -1)[rank],
                rtol=1e-4, atol=1e-5)


def test_rng_tracker_streams(setup):
    _, _, ranks = setup
    (g0, l0), (g1, l1) = ranks[0]["rng"], ranks[1]["rng"]
    np.testing.assert_array_equal(g0, g1)      # global: the same draws
    assert not np.array_equal(l0, l1)          # local: per rank


def test_shard_state_round_trip(setup):
    from paddle_tpu_torch.bridge import shard_state

    _, states, _ = setup
    for name, tps in (("tiny", (2, 4)), ("gqa", (2,))):
        cfg = GPTConfig(**CONFIGS[name])
        for tp in tps:
            back = gather_state([shard_state(states[name], cfg, tp, r)
                                 for r in range(tp)], cfg)
            for k, v in states[name].items():
                np.testing.assert_array_equal(back[k], v, err_msg=k)
    # GQA groups stay whole: tp must divide the kv heads
    with pytest.raises(ValueError, match="num_kv_heads"):
        shard_state(states["gqa"], GPTConfig(**CONFIGS["gqa"]), 4, 0)


def _replicas(ranks, key):
    """{dp rank: its mp ranks' ``key`` gathered to full shape}."""
    cfg = GPTConfig(**CONFIGS["tiny"])
    by_dp = {}
    for r in ranks:
        by_dp.setdefault(r["dp_rank"], []).append(r)
    return {d: gather_state([r[key] for r in sorted(rs, key=lambda r:
                                                     r["mp_rank"])], cfg)
            for d, rs in by_dp.items()}


def test_dp_mp_hybrid_gradients_match_jax(hybrid):
    ref, ranks = hybrid
    assert [(r["dp_rank"], r["mp_rank"]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert r["wrapper"] == "TensorParallel"
        assert r["dp_sep_ranks"] == [r["mp_rank"], r["mp_rank"] + 2]
    for d, got in _replicas(ranks, "grads").items():
        for k, g in got.items():
            w = ref["grads"][k]
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * float(np.abs(w).max()),
                                       err_msg=f"dp {d}: {k}")


def test_dp_mp_hybrid_train_steps_match_jax(hybrid):
    ref, ranks = hybrid
    for r in ranks:
        assert r["step_syncs"] == 3
        np.testing.assert_allclose(r["step_losses"], ref["losses"],
                                   rtol=1e-5, atol=1e-5)
    for d, got in _replicas(ranks, "step_params").items():
        for k, v in got.items():
            np.testing.assert_allclose(v, ref["params"][k], atol=1e-5,
                                       rtol=0, err_msg=f"dp {d}: {k}")
