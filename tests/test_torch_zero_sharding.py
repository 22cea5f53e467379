"""ZeRO stages 1-3 of the port against the JAX package's
(``tests/test_zero_sharding.py``'s runs, at dp 4): 4 gloo ranks, each with
its 2 rows of the 8-row batch, train ``Linear(16, 64) -> GELU ->
Linear(64, 10)`` for 5 AdamW steps through ``jit.TrainStep`` under
``shard_optimizer(AdamW, ShardingStage{1,2,3}("dp", mesh))``; JAX runs the
same on its 4-device "dp" mesh with the batch sharded over it.

Held: the mean of the ranks' losses against JAX's (rtol 1e-5, atol 1e-6,
JAX's own bound) and against JAX's unsharded step; the gathered
parameters within a ``param_gap`` of 1e-3 (the summed difference over
the summed movement: AdamW's normalised update makes an elementwise bound
measure single elements); the local sizes: accumulators, gradients and
(stage 3) parameters at 1/4 where JAX's ``_spec`` shards dim 0 and whole
where it does not (the last bias, 10 rows); the eager ``step`` equal to
the captured form; ``DataParallel`` over the same ranks leaving the sync
to the stage; and a non-finite gradient on one rank under
``shard_scaler`` skipping the step on every rank.
"""
import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

import dist_ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn
from paddle_tpu.jit.train import TrainStep as JTrainStep

from paddle_tpu_torch.bridge import gather_parts

DP, DIM, OUT, STEPS = 4, 16, 10, 5
SHARDED = {"0.weight": True, "0.bias": True, "2.weight": True,
           "2.bias": False}


def _jax_model():
    paddle.seed(0)
    return nn.Sequential(nn.Linear(DIM, 4 * DIM), nn.GELU(),
                         nn.Linear(4 * DIM, OUT))


def _data():
    rs = np.random.RandomState(0)
    return (rs.randn(DP * 2, DIM).astype("float32"),
            rs.randn(DP * 2, OUT).astype("float32"))


def _state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def _jax_run(stage):
    mesh = jdist.auto_mesh(DP, dim_names=["dp"])
    prev = jdist.get_mesh()
    jdist.set_mesh(mesh)
    try:
        model = _jax_model()
        opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                     parameters=model.parameters())
        if stage is not None:
            opt = jdist.shard_optimizer(opt, stage("dp", mesh))
        loss_fn = nn.MSELoss()
        step = JTrainStep(model, lambda o, y: loss_fn(o, y), opt)
        x, y = _data()
        bsh = NamedSharding(mesh.jax_mesh, PartitionSpec("dp"))
        x = paddle.Tensor(jax.device_put(paddle.to_tensor(x)._value, bsh))
        y = paddle.Tensor(jax.device_put(paddle.to_tensor(y)._value, bsh))
        losses = [float(step(x, y)) for _ in range(STEPS)]
        return losses, _state(model)
    finally:
        jdist.set_mesh(prev)


def param_gap(got, want, init):
    moved = float(np.abs(want - init).sum())
    return float(np.abs(got - want).sum()) / max(moved, 1e-30)


BODIES = ["body_zero1", "body_zero2", "body_zero3", "body_zero2_eager",
          "body_zero3_eager", "body_zero1_data_parallel", "body_zero_scaler"]


@pytest.fixture(scope="module")
def runs():
    init = _state(_jax_model())
    jax_runs = {None: _jax_run(None)}
    for k, cls in ((1, jdist.ShardingStage1), (2, jdist.ShardingStage2),
                   (3, jdist.ShardingStage3)):
        jax_runs[k] = _jax_run(cls)
    x, y = _data()
    inputs = {"zero_state": init, "zero_x": x, "zero_y": y,
              "zero_steps": STEPS}
    ranks = dist_ranks.run_ranks([f"dist_pipeline_bodies:{b}"
                                  for b in BODIES], DP, inputs)
    got = {b: [r[f"dist_pipeline_bodies:{b}"] for r in ranks]
           for b in BODIES}
    return init, jax_runs, got


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_matches_jax(runs, stage):
    init, jax_runs, got = runs
    ranks = got[f"body_zero{stage}"]
    mean = np.mean([r["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(mean, jax_runs[stage][0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mean, jax_runs[None][0], rtol=1e-5,
                               atol=1e-6)
    whole = gather_parts([r["params"] for r in ranks])
    for k, v in whole.items():
        assert param_gap(v, jax_runs[stage][1][k], init[k]) <= 1e-3, k
        assert param_gap(v, jax_runs[None][1][k], init[k]) <= 1e-3, k


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_local_sizes(runs, stage):
    """Accumulators (every stage), gradients (stages 2-3) and parameters
    (stage 3) at 1/4 of dim 0 where it divides by 4, whole where not."""
    init, _, got = runs
    for rank, r in enumerate(got[f"body_zero{stage}"]):
        for k, full in init.items():
            want = ((full.shape[0] // DP,) + full.shape[1:]
                    if SHARDED[k] else full.shape)
            for acc in ("moment1", "moment2"):
                assert r["acc_shapes"][acc][k] == want, (rank, acc, k)
            assert r["grad_shapes"][k] == (
                want if stage >= 2 else want), (rank, k)
            assert r["param_shapes"][k] == (want if stage == 3
                                            else full.shape), (rank, k)
        assert r["clip"] is None


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_moments_gather_to_the_unsharded_ones(runs, stage):
    """Every rank's rows of moment1, put back where their layout says,
    equal one unsharded AdamW's moments: stage 1's ranks hold the same
    rows as stage 2's and 3's."""
    _, _, got = runs
    mom = {s: gather_parts([r["opt_state"] for r in got[f"body_zero{s}"]])
           for s in (1, 2, 3)}
    for k, v in mom[stage].items():
        np.testing.assert_allclose(v, mom[1][k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("stage", [2, 3])
def test_eager_step_matches_train_step(runs, stage):
    init, jax_runs, got = runs
    eager = got[f"body_zero{stage}_eager"]
    mean = np.mean([r["losses"] for r in eager], axis=0)
    np.testing.assert_allclose(mean, jax_runs[stage][0], rtol=1e-5,
                               atol=1e-6)
    whole = gather_parts([r["params"] for r in eager])
    for k, v in whole.items():
        assert param_gap(v, jax_runs[stage][1][k], init[k]) <= 1e-3, k


def test_stage3_frees_gathered_weights_between_forward_and_backward(runs):
    """Under TrainStep stage 3's forward runs inside ``saving()``: every
    gathered weight the backward keeps is dropped after the forward and
    gathered again from the rows when the backward reads it. The backward
    keeps one a step: the second linear's weight (for its input's
    gradient; the first's input, the batch, needs none). Stages 1-2
    gather nothing."""
    _, _, got = runs
    for r in got["body_zero3"]:
        assert r["regathered"] == STEPS, r["regathered"]
    for k in (1, 2):
        assert all(r["regathered"] == 0 for r in got[f"body_zero{k}"])


@pytest.mark.parametrize("stage,eager", [(1, False), (2, False),
                                         (3, False), (2, True), (3, True)])
def test_stage3_leaves_no_global_hook(runs, stage, eager):
    """Stage 3's properties go on the modules that own rows, on a subclass
    made once and put back by ``uninstall``: ``TrainStep`` sets them at
    its construction, an eager run at its first forward, and then no
    global forward hook is left. Stages 1 and 2 change no class."""
    got = runs[2]
    body = f"body_zero{stage}" + ("_eager" if eager else "")
    for r in got[body]:
        assert r["hooks_left"] == 0
        assert r["hook_at_bind"] == (stage == 3)
        assert r["swapped"] == (["Linear", "Linear"] if stage == 3 else [])
        assert r["swapped_after_uninstall"] == []


def test_data_parallel_leaves_the_sync_to_the_stage(runs):
    """DataParallel over the stage's ranks: its backward's sync skips the
    group ZeRO-1 averages over (one sync per axis), so the run is the bare
    stage's bit for bit, not a double average."""
    _, _, got = runs
    for dp, bare in zip(got["body_zero1_data_parallel"], got["body_zero1"]):
        assert dp["dp_syncs"] == STEPS
        assert dp["losses"] == bare["losses"]
        for k, (arr, _, _) in dp["params"].items():
            np.testing.assert_array_equal(arr, bare["params"][k][0])


def test_shard_scaler_skips_the_step_on_every_rank(runs):
    _, _, got = runs
    for r in got["body_zero_scaler"]:
        assert r["unchanged"] and r["scale"] == 512.0 and r["moved"]
