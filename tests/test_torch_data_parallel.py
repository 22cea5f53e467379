"""The port's ``DataParallel`` on two gloo ranks against the JAX package's
over the fake CPU devices (``tests/test_data_parallel.py``, all five).

The JAX package shards one global batch over the devices; each port rank
passes its own rows. Held, with the same weights (numpy through
``bridge.py``) and the same data:

* each rank's outputs are JAX's output rows of its part of the batch
  (1e-6 relative);
* after backward, every rank's gradients are JAX's gradients of the global
  batch's mean loss (rtol 1e-4, atol 1e-5 as the JAX test), for an even
  split and an uneven one (3 + 2 rows: the all-reduce weights each rank by
  its share), and after ``no_sync`` + ``apply_collective_grads``;
* ten SGD steps: the mean of the ranks' losses is JAX's loss at every step
  (rtol 1e-5) and falls; ``state_dict`` is the inner model's;
* three ``TrainStep`` steps through the wrapper on a 4 + 2 split: the
  parameters are those of three JAX SGD steps on all six rows (1e-5);
* ``shard_dataloader``: each rank reads its half of every batch.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn

import dist_ranks


def _make(seed):
    with paddle.utils.unique_name.guard():
        paddle.seed(seed)
        return jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(),
                              jnn.Linear(32, 4))


def _state(net):
    return {k: np.asarray(v._value) for k, v in net.state_dict().items()}


def _jgrads(net):
    return {k: np.asarray(p.grad) for k, p in net.named_parameters()}


def _data():
    rng = np.random.default_rng(1)
    d = {"x16": rng.standard_normal((16, 16)).astype("float32"),
         "y16": rng.integers(0, 4, (16,)),
         "x5": rng.standard_normal((5, 16)).astype("float32"),
         "y5": rng.integers(0, 4, (5,)),
         "x6": rng.standard_normal((6, 16)).astype("float32"),
         "y6": rng.integers(0, 4, (6,)),
         "x32": rng.standard_normal((32, 16)).astype("float32"),
         "y32": rng.integers(0, 4, (32,)),
         "x64": rng.standard_normal((64, 16)).astype("float32"),
         "y64": rng.integers(0, 4, (64, 1))}
    return d


@pytest.fixture(scope="module")
def setup():
    d = _data()
    T = paddle.to_tensor
    nets = {s: _make(s) for s in (0, 3, 4, 7)}
    inputs = dict(d, **{f"s{s}": _state(n) for s, n in nets.items()})
    ref = {}
    # JAX's DataParallel over the 8 fake devices
    ref["shard_out"] = np.asarray(jdist.DataParallel(nets[0])(
        T(d["x16"]))._value)
    net = _make(7)
    dp = jdist.DataParallel(net)
    loss = dp.scale_loss(JF.cross_entropy(dp(T(d["x16"])), T(d["y16"])))
    loss.backward()
    dp.apply_collective_grads()
    ref["grads"] = _jgrads(net)
    net = _make(4)
    dp = jdist.DataParallel(net)
    out = dp(T(d["x5"]))          # 5 rows over 8 devices: replicated
    JF.cross_entropy(out, T(d["y5"])).backward()
    ref["uneven_out"], ref["uneven_grads"] = np.asarray(out._value), \
        _jgrads(net)
    net = _make(3)
    dp = jdist.DataParallel(net)
    opt = paddle.optimizer.SGD(0.5, parameters=dp.parameters())
    losses = []
    for _ in range(10):
        loss = JF.cross_entropy(dp(T(d["x32"])), T(d["y32"]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    ref["losses"] = losses
    net = _make(4)
    opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
    for _ in range(3):
        loss = JF.cross_entropy(net(T(d["x6"])), T(d["y6"]))
        loss.backward()
        opt.step()
        opt.clear_grad()
    ref["step_params"] = _jgrads_free(net)
    ranks = dist_ranks.run_ranks(["body_data_parallel"], 2, inputs)
    return d, ref, [r["body_data_parallel"] for r in ranks]


def _jgrads_free(net):
    return {k: np.asarray(p._value) for k, p in net.named_parameters()}


def _same_grads(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_dp_shards_batch_over_ranks(setup):
    _, ref, ranks = setup
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["shard_out"],
                                   ref["shard_out"][8 * r:8 * (r + 1)],
                                   rtol=1e-6, atol=1e-6)


def test_dp_gradients_match_single_device(setup):
    _, ref, ranks = setup
    for res in ranks:
        _same_grads(res["grads"], ref["grads"])
        assert res["syncs"] == 1


def test_dp_no_sync_then_apply_collective_grads(setup):
    _, ref, ranks = setup
    # under no_sync each rank kept its own half's gradients
    assert not np.allclose(ranks[0]["local_grads"]["0.weight"],
                           ranks[1]["local_grads"]["0.weight"])
    for res in ranks:
        _same_grads(res["no_sync_grads"], ref["grads"])


def test_dp_training_converges_and_state_passthrough(setup):
    _, ref, ranks = setup
    for res in ranks:
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=1e-5)
        assert res["losses"][-1] < res["losses"][0]
        assert res["state_keys"]


def test_dp_indivisible_batch_still_correct(setup):
    """5 rows as 3 + 2: each rank's rows of the output, and the global
    mean's gradients on both ranks."""
    _, ref, ranks = setup
    np.testing.assert_allclose(ranks[0]["uneven_out"], ref["uneven_out"][:3],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ranks[1]["uneven_out"], ref["uneven_out"][3:],
                               rtol=1e-6, atol=1e-6)
    for res in ranks:
        _same_grads(res["uneven_grads"], ref["uneven_grads"])


def test_dp_train_step_uneven_split(setup):
    _, ref, ranks = setup
    for res in ranks:
        assert res["step_syncs"] == 3
        for k, v in ref["step_params"].items():
            np.testing.assert_allclose(res["step_params"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_allclose(ranks[0]["step_params"]["0.weight"],
                               ranks[1]["step_params"]["0.weight"])


def test_shard_dataloader_places_batches(setup):
    d, _, ranks = setup
    for r, res in enumerate(ranks):
        same_len, xb, yb = res["loader"]
        assert same_len
        np.testing.assert_allclose(xb, d["x64"][8 * r:8 * (r + 1)])
        np.testing.assert_allclose(yb, d["y64"][8 * r:8 * (r + 1)])
