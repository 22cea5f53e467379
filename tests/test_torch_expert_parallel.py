"""Expert parallelism of the port on eight gloo ranks, against the JAX
package's mesh bodies (``tests/test_moe.py:123``, ``:144``) and its
whole-batch runs.

* ``global_scatter`` / ``global_gather`` (``distributed.utils``): the
  rank-major blocks move from (i, j) to (j, i), the gather brings every
  rank's buffer back, and the gradient is the same exchange.
* ``[dp 1, ep 8]``: eight scale experts, one a rank; every rank the whole
  batch (GSPMD replicates it at dp 1): the output equals JAX's unsharded
  layer within rtol 1e-5 / atol 1e-6, and each rank drops the tokens
  JAX's layer drops (the whole batch is every rank's split).
* ``[dp 2, ep 4]`` (``__graft_entry__.py:363``'s model: linear, gshard MoE
  of four experts, linear), each rank two rows of a 16-row batch through
  ``DataParallel`` and a ``TrainStep`` of AdamW with the gshard loss,
  against JAX's TrainStep on the whole batch (which GSPMD makes equal to
  its mesh run): after each of 3 steps the mean of the ranks' losses
  within 1e-5 relative, and every parameter within 1e-4 of how far JAX
  moved it (L2 distances over the tensor). No token is dropped, on any
  rank or in JAX (a dropped token makes the output depend on how the
  batch is split). The control, with
  the expert gradients summed over the whole world, fails the parameter
  check.
* The ``[dp 2, ep 4]`` run on a 14-row batch split unevenly over the
  ranks (``UNEVEN`` rows each, so ranks of one expert group differ and
  so do the two groups): every rank's loss weighs its share of the
  batch, also in the expert gradients that other ranks' tokens send back
  and in the balance loss's gradient, so the mean loss weighted by rows
  and the parameters meet the same bounds against JAX's whole-batch run.
  The ranks of an expert group must route the same capacity (the
  exchange's blocks are of one size): 2 and 3 tokens both give 2.
* A capacity that binds (factor 0.5): each rank's output is JAX's
  single-device layer on that rank's rows, drops included.
* The hybrid global-norm clip adds each expert's squares once across ep:
  its norm is JAX's whole-model gradient norm (1e-5 relative).

All bodies run in one spawn of eight ranks.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.incubate.distributed.models.moe import GShardGate, MoELayer

import dist_model_bodies as bodies
import dist_ranks

WORLD = 8
D, E = 16, 4
# rows of the 14-row batch on each rank in the uneven leg (the expert
# groups are ranks 0-3 and 4-7; each routes one capacity)
UNEVEN = [2, 3, 2, 3, 1, 1, 1, 1]


def _state(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


def _jax_drops(model, x, T):
    h = model.inp(paddle.to_tensor(x))
    logits = h._value @ model.moe.gate.weight._value
    gate = model.moe.gate
    _, _, keeps, _, _ = gate.route_indices(logits,
                                           min(gate.capacity_for(T), T))
    return int((~np.asarray(keeps)).sum())


def _scale_case():
    import jax.numpy as jnp

    rs = np.random.RandomState(4)
    with paddle.utils.unique_name.guard():
        paddle.seed(4)
        experts = []
        for i in range(WORLD):
            e = jnn.Linear(8, 8)
            e.weight._value = jnp.eye(8, dtype=jnp.float32) * (i + 1)
            e.bias._value = jnp.zeros(8, jnp.float32)
            experts.append(e)
        layer = MoELayer(8, experts, gate="gshard")
    x = rs.randn(32, 8).astype("float32")
    out = np.asarray(layer(paddle.to_tensor(x))._value)
    logits = paddle.to_tensor(x)._value @ layer.gate.weight._value
    _, _, keeps, _, _ = layer.gate.route_indices(
        logits, min(layer.gate.capacity_for(32), 32))
    return {"D": 8, "x": x, "gate_w": np.asarray(layer.gate.weight._value)}, \
        (out, int((~np.asarray(keeps)).sum()))


def _ep_case(steps, rows, seed=0):
    from paddle_tpu.jit.train import TrainStep

    rs = np.random.RandomState(seed)
    x = rs.randn(rows, D).astype("float32")
    y = rs.randint(0, 4, rows).astype("int64")
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        model = bodies.moe_model(paddle, D, E)
    state = _state(model)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
    lf = jnn.CrossEntropyLoss()
    step = TrainStep(model, lambda o, t: lf(o, t)
                     + model.moe.gate.get_loss(clear=False), opt)
    losses, drops = [], []
    for _ in range(steps):
        drops.append(_jax_drops(model, x, rows))
        losses.append(float(step(paddle.to_tensor(x), paddle.to_tensor(y))))
    return ({"D": D, "E": E, "x": x, "y": y, "state": state,
             "steps": steps},
            {"losses": losses, "drops": drops, "params": _state(model),
             "init": state})


def _clip_norm(case):
    with paddle.utils.unique_name.guard():
        model = bodies.moe_model(paddle, D, E)
    model.set_state_dict({k: paddle.to_tensor(v)
                          for k, v in case["state"].items()})
    out = model(paddle.to_tensor(case["x"]))
    loss = jnn.CrossEntropyLoss()(out, paddle.to_tensor(case["y"])) \
        + model.moe.gate.get_loss(clear=False)
    loss.backward()
    sq = sum(float((np.asarray(p.grad._value if hasattr(p.grad, "_value")
                               else p.grad).astype(np.float64) ** 2).sum())
             for p in model.parameters())
    return float(np.sqrt(sq))


def _bind_case():
    rs = np.random.RandomState(7)
    with paddle.utils.unique_name.guard():
        paddle.seed(7)
        gate = GShardGate(D, E, capacity=(0.5, 2.4))
        layer = MoELayer(D, bodies.moe_experts(paddle, D, E, 2 * D),
                         gate=gate)
    x = rs.randn(4 * WORLD, D).astype("float32")
    outs, drops = [], []
    for r in range(WORLD):
        rows = x[4 * r:4 * (r + 1)]
        outs.append(np.asarray(layer(paddle.to_tensor(rows))._value))
        h = paddle.to_tensor(rows)._value @ layer.gate.weight._value
        _, _, keeps, _, _ = layer.gate.route_indices(h, 1)
        drops.append(int((~np.asarray(keeps)).sum()))
    return {"D": D, "E": E, "factor": 0.5, "x": x,
            "state": _state(layer)}, outs, drops


@pytest.fixture(scope="module")
def setup():
    scale_in, scale_out = _scale_case()
    ep_in, ep_ref = _ep_case(3, 16)
    uneven_in, uneven_ref = _ep_case(3, sum(UNEVEN), seed=1)
    uneven_in["sizes"] = UNEVEN
    bind_in, bind_out, bind_drops = _bind_case()
    ref = {"scale": scale_out, "ep": ep_ref, "uneven": uneven_ref,
           "bind": bind_out,
           "bind_drops": bind_drops, "clip_norm": _clip_norm(ep_in)}
    a2a = np.arange(WORLD * WORLD * 2 * 4, dtype=np.float32).reshape(
        WORLD * WORLD * 2, 4)
    ranks = dist_ranks.run_ranks(
        ["dist_model_bodies:body_global_scatter",
         "dist_model_bodies:body_expert_parallel"], WORLD,
        {"a2a": a2a, "scale_case": scale_in, "ep_case": ep_in,
         "bind_case": bind_in, "uneven_case": uneven_in})
    return a2a, ref, ranks


def test_global_scatter_permutes_rank_major_blocks(setup):
    a2a, _, ranks = setup
    got = np.stack([r["dist_model_bodies:body_global_scatter"]["scattered"]
                    for r in ranks])
    blocks = got.reshape(WORLD, WORLD, 2, 4)
    orig = a2a.reshape(WORLD, WORLD, 2, 4)
    np.testing.assert_array_equal(blocks, np.swapaxes(orig, 0, 1))


def test_global_gather_undoes_scatter(setup):
    a2a, _, ranks = setup
    for r, res in enumerate(ranks):
        res = res["dist_model_bodies:body_global_scatter"]
        np.testing.assert_array_equal(res["back"], a2a.reshape(
            WORLD, -1, 4)[r])
        assert res["identity"]


def test_global_scatter_gradient_is_the_exchange(setup):
    """d/dmine of sum(scatter(mine) * w) is the exchange of w."""
    _, _, ranks = setup
    n = WORLD * 2 * 4
    w = np.arange(n, dtype=np.float32).reshape(WORLD, 2, 4)
    for r, res in enumerate(ranks):
        g = res["dist_model_bodies:body_global_scatter"]["grad"]
        # block j of my grad is block r of rank j's weights
        np.testing.assert_array_equal(g.reshape(WORLD, 2, 4),
                                      np.stack([w[r]] * WORLD))


def test_moe_expert_parallel_sharded_matches_unsharded(setup):
    """At dp 1 every rank routes the whole batch, so the split cannot
    change which tokens drop: the JAX body's data drops the same tokens
    on every rank as JAX's unsharded layer does."""
    _, ref, ranks = setup
    out, drops = ref["scale"]
    for res in ranks:
        s = res["dist_model_bodies:body_expert_parallel"]["scale"]
        assert s["n_local"] == 1 and s["dropped"] == drops
        np.testing.assert_allclose(s["out"], out, rtol=1e-5, atol=1e-6)


def test_experts_that_do_not_split_over_ep_raise(setup):
    _, _, ranks = setup
    for res in ranks:
        msg = res["dist_model_bodies:body_expert_parallel"]["indivisible"]
        assert msg is not None and "do not split" in msg


def _ep(ranks, key):
    return [r["dist_model_bodies:body_expert_parallel"][key] for r in ranks]


def _params_match(results, ref):
    whole = {}
    for res in results:
        whole.update(res["params"])
    assert set(whole) == set(ref["params"])
    for k, want in ref["params"].items():
        # distances as L2 norms over the tensor: how far JAX moved it, and
        # how far the port's value is from JAX's
        moved = np.linalg.norm((want - ref["init"][k]).astype(np.float64))
        err = np.linalg.norm((whole[k] - want).astype(np.float64))
        assert err <= 1e-4 * max(moved, 1e-12), (k, err, moved)


def test_ep_train_step_matches_jax_whole_batch(setup):
    _, ref, ranks = setup
    res = _ep(ranks, "train")
    assert all(r["n_local"] == E // 4 for r in res)
    # no token dropped, on any rank or in JAX
    assert all(d == 0 for r in res for d in r["dropped"])
    assert all(d == 0 for d in ref["ep"]["drops"])
    mean = np.mean([r["losses"] for r in res], axis=0)
    np.testing.assert_allclose(mean, ref["ep"]["losses"], rtol=1e-5)
    _params_match(res, ref["ep"])


def test_ep_train_step_with_uneven_batches_matches_jax_whole_batch(setup):
    """Uneven local batches: the mean of the ranks' losses weighted by
    their rows is JAX's whole-batch loss, and every parameter, the
    experts' included, meets the same bound."""
    _, ref, ranks = setup
    res = _ep(ranks, "uneven")
    assert [r["rows"] for r in res] == UNEVEN
    assert all(d == 0 for r in res for d in r["dropped"])
    assert all(d == 0 for d in ref["uneven"]["drops"])
    w = np.asarray(UNEVEN, dtype=np.float64) / sum(UNEVEN)
    mean = np.einsum("r,rs->s", w, [r["losses"] for r in res])
    np.testing.assert_allclose(mean, ref["uneven"]["losses"], rtol=1e-5)
    _params_match(res, ref["uneven"])


def test_expert_gradients_synced_over_the_world_fail(setup):
    """The control: the expert gradients summed over every rank (other
    experts' gradients added in) fail the parameter check."""
    _, ref, ranks = setup
    with pytest.raises(AssertionError):
        _params_match(_ep(ranks, "control"), ref["ep"])


def test_binding_capacity_matches_jax_per_rank_rows(setup):
    _, ref, ranks = setup
    res = _ep(ranks, "bind")
    assert sum(r["dropped"] for r in res) == sum(ref["bind_drops"]) > 0
    for r, got in enumerate(res):
        assert got["dropped"] == ref["bind_drops"][r]
        np.testing.assert_allclose(got["out"], ref["bind"][r], rtol=1e-5,
                                   atol=1e-6)


def test_hybrid_clip_counts_each_expert_once_across_ep(setup):
    _, ref, ranks = setup
    for n in _ep(ranks, "clip_norm"):
        np.testing.assert_allclose(n, ref["clip_norm"], rtol=1e-5)


def test_counts_are_checked_against_the_padded_layout():
    """``local_count`` / ``global_count`` (Paddle's per-(rank, expert)
    token counts) must describe the rank-major blocks of the buffer and
    fit each block's capacity; JAX's docstring promises the check and its
    code reads neither (ROADMAP C). Without a group the op is the
    identity."""
    import torch

    from paddle_tpu_torch.distributed.utils import moe_utils

    x = torch.zeros(2 * 3 * 4, 8)        # 2 ranks x 3 experts x capacity 4
    assert moe_utils.global_scatter(x) is x
    moe_utils._check_counts(24, 2, torch.tensor([4, 0, 2, 1, 3, 4]), None)
    with pytest.raises(ValueError, match="does not describe"):
        moe_utils._check_counts(24, 2, torch.tensor([1, 1, 1]), None)
    with pytest.raises(ValueError, match="capacity 4"):
        moe_utils._check_counts(24, 2, None,
                                torch.tensor([5, 0, 0, 0, 0, 0]))
