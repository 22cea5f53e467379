"""The port's ``SyncBatchNorm`` on two gloo ranks against the JAX
package's ``BatchNorm`` run on the whole batch.

JAX's ``SyncBatchNorm`` is ``BatchNorm`` under GSPMD: with the batch axis
sharded its statistics are over the whole batch. A small conv net with two
``BatchNorm2D`` layers, converted by ``convert_sync_batchnorm``, each rank
taking half of a seeded batch under ``DataParallel``: every rank's outputs
are JAX's rows of its half, the running means and variances JAX's after
the same forward, and every gradient after the data-parallel sync JAX's
gradient of the whole batch's mean loss, within 1e-5 relative (f32). The
control, the same net without the conversion (per-rank statistics, as
Paddle's plain ``BatchNorm`` under ``DataParallel``), fails the same
assertion. With the first conv's bias moved by 100 (channels whose mean
dwarfs their spread) the converted net is held to a float64 whole batch,
within JAX's own f32 error of it. All cases run in one spawn of
two ranks.
"""
import numpy as np
import pytest

import paddle_tpu as paddle

import dist_model_bodies
import dist_ranks

RTOL, ATOL = 1e-5, 1e-6


OFFSET = 100.0


def _jax_whole_batch(state, x, y):
    with paddle.utils.unique_name.guard():
        net = dist_model_bodies.bn_net(paddle)
    net.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    out = net(paddle.to_tensor(x))
    loss = ((out - paddle.to_tensor(y)) ** 2).mean()
    loss.backward()
    return {"out": np.asarray(out._value),
            "grads": {k: np.asarray(p.grad._value if hasattr(p.grad, "_value")
                                    else p.grad)
                      for k, p in net.named_parameters()},
            "stats": {k: np.asarray(v._value)
                      for k, v in net.state_dict().items()
                      if k.endswith(("_mean", "_variance"))}}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 3, 6, 6)).astype("float32")
    y = rng.standard_normal((8, 3)).astype("float32")
    with paddle.utils.unique_name.guard():
        paddle.seed(11)
        net = dist_model_bodies.bn_net(paddle)
    state = {k: np.asarray(v._value) for k, v in net.state_dict().items()}
    ref = _jax_whole_batch(state, x, y)
    # the first conv's bias moved by OFFSET: its channels' mean dwarfs
    # their spread where the first BatchNorm reads them
    offset_state = dict(state, **{"0.bias": state["0.bias"] + OFFSET})
    ref_offset = _jax_whole_batch(offset_state, x, y)
    ranks = dist_ranks.run_ranks(["dist_model_bodies:body_sync_batchnorm"],
                                 2, {"x": x, "y": y, "state": state,
                                     "offset_state": offset_state})
    return (ref, [r["dist_model_bodies:body_sync_batchnorm"] for r in ranks],
            ref_offset, _f64_whole_batch(offset_state, x, y))


def _matches(res, ref, rank):
    rows = slice(4 * rank, 4 * (rank + 1))
    np.testing.assert_allclose(res["out"], ref["out"][rows], rtol=RTOL,
                               atol=ATOL)
    assert set(res["stats"]) == set(ref["stats"])
    for k in ref["stats"]:
        np.testing.assert_allclose(res["stats"][k], ref["stats"][k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert set(res["grads"]) == set(ref["grads"])
    for k in ref["grads"]:
        np.testing.assert_allclose(res["grads"][k], ref["grads"][k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
def test_sync_batchnorm_matches_whole_batch_batchnorm(setup, rank):
    ref, ranks = setup[:2]
    res = ranks[rank]["sync"]
    assert res["kinds"].count("SyncBatchNorm") == 2
    _matches(res, ref, rank)


@pytest.mark.parametrize("rank", [0, 1])
def test_unconverted_batchnorm_stays_per_rank(setup, rank):
    """The control: plain BatchNorm under DataParallel normalises over the
    rank's rows, and fails the whole-batch assertion."""
    ref, ranks = setup[:2]
    res = ranks[rank]["plain"]
    assert "SyncBatchNorm" not in res["kinds"]
    with pytest.raises(AssertionError):
        _matches(res, ref, rank)


def _f64_whole_batch(state, x, y):
    """``bn_net`` in float64 through torch's own ops on the whole batch:
    the truth both f32 runs are measured against."""
    import torch

    F = torch.nn.functional
    t = {k: torch.tensor(v, dtype=torch.float64) for k, v in state.items()}
    params = {k: v.requires_grad_(True) for k, v in t.items()
              if not k.endswith(("_mean", "_variance"))}
    h = torch.tensor(x, dtype=torch.float64)
    for conv, bn in (("0", "1"), ("3", "4")):
        h = F.conv2d(h, params[conv + ".weight"], params[conv + ".bias"],
                     padding=1)
        h = F.relu(F.batch_norm(h, t[bn + "._mean"], t[bn + "._variance"],
                                params[bn + ".weight"], params[bn + ".bias"],
                                training=True, momentum=0.1, eps=1e-5))
    out = h.flatten(1) @ params["7.weight"] + params["7.bias"]
    ((out - torch.tensor(y, dtype=torch.float64)) ** 2).mean().backward()
    return {"out": out.detach().numpy(),
            "grads": {k: p.grad.numpy() for k, p in params.items()},
            "stats": {k: v.numpy() for k, v in t.items()
                      if k.endswith(("_mean", "_variance"))}}


def test_sync_batchnorm_is_exact_on_channels_far_from_zero(setup):
    """The first conv's bias moved by 100: the channels the first
    BatchNorm reads have a mean far larger than their spread, where a
    one-pass ``E[x^2] - mean^2`` variance cancels in f32. Against the
    float64 whole batch, every output, statistic and gradient of the two
    ranks is within JAX's own whole-batch f32 error (per tensor, the
    largest error over the largest value; at least 1e-6, a few f32
    roundings). The biases of the convs that feed a BatchNorm are left
    out: their true gradient is zero."""
    ref_offset, ranks, truth = setup[2], setup[1], setup[3]
    res = [r["sync_offset"] for r in ranks]
    assert all(r["kinds"].count("SyncBatchNorm") == 2 for r in res)

    def err(got, want):
        return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))

    pairs = [("out", np.concatenate([r["out"] for r in res]),
              ref_offset["out"], truth["out"])]
    for kind in ("stats", "grads"):
        for k, want in truth[kind].items():
            if k not in ("0.bias", "3.bias"):
                pairs.append((k, res[0][kind][k], ref_offset[kind][k], want))
    for k, got, jax_got, want in pairs:
        assert err(got, want) <= max(err(jax_got, want), 1e-6), (
            k, err(got, want), err(jax_got, want))


def test_convert_keeps_parameters_and_buffers(setup):
    ranks = setup[1]
    assert all(r["same_tensors"] for r in ranks)


def test_one_rank_sync_batchnorm_is_batchnorm_bit_for_bit():
    """No process group: SyncBatchNorm is BatchNorm, bit for bit, in the
    outputs, the gradients and the running statistics."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.framework import device as port_device

    prev = port_device._current["place"]
    P.set_device("cpu")
    try:
        x = np.random.default_rng(2).standard_normal(
            (6, 3, 5, 5)).astype("float32")
        res = []
        for sync in (False, True):
            P.seed(3)
            net = P.nn.Sequential(P.nn.Conv2D(3, 4, 3), P.nn.BatchNorm2D(4))
            if sync:
                net = P.nn.SyncBatchNorm.convert_sync_batchnorm(net)
            out = net(P.to_tensor(x))
            (out ** 2).sum().backward()
            res.append([out.numpy(), net[0].weight.grad.numpy(),
                        net[1].weight.grad.numpy(),
                        net[1]._mean.numpy().copy(),
                        net[1]._variance.numpy().copy()])
        for a, b in zip(*res):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    finally:
        port_device._current["place"] = prev
