"""Hybrid PP x DP x TP x ZeRO of the port against the JAX package's
(``tests/test_hybrid_parallel.py``): 8 gloo ranks, each one stage's
(dp, sharding, mp) coordinate, run JAX's three configurations (pp 2 x dp
2 x mp 2; pp 2 x mp 2 x sharding 2 with ZeRO-2; pp 2 x dp 2 x sharding 2
with ZeRO-3) of its column / row-parallel MLP blocks under
``PipelineParallel``, 6 SGD steps, against JAX's ``_run_hybrid`` losses
and its single-device micro-batch accumulation, from the same weights.

Held: losses within rtol 1e-5, atol 1e-6 (JAX's bound); the gathered
parameters within atol 1e-6 of JAX's; each rank holds only its stage's
parameters, the tensor-parallel ones halved (ZeRO-3 rows halved again);
ZeRO-2's gradients are rows over "sharding"; and the hybrid global-norm
clip (squared norms summed over mp, sharding and pp, each gradient
counted once) gives JAX's clip of the whole model.
"""
import numpy as np
import pytest

import dist_ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn
from paddle_tpu.distributed.fleet import DistributedStrategy
from paddle_tpu.distributed.fleet.base import HybridCommunicateGroup
from paddle_tpu.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, LayerDesc, PipelineLayer, PipelineParallel,
    RowParallelLinear,
)

from paddle_tpu_torch.bridge import gather_parts

HID, MICRO, BATCH, N_BLOCKS, STEPS = 16, 4, 8, 4, 6
CLIP = 0.05
CONFIGS = {"body_hybrid_pp_dp_mp": (2, 2, 2, 1, 0),
           "body_hybrid_pp_mp_zero2": (2, 1, 2, 2, 2),
           "body_hybrid_pp_dp_zero3": (2, 2, 1, 2, 3)}


class _MLPBlock(nn.Layer):
    def __init__(self):
        super().__init__()
        self.up = ColumnParallelLinear(HID, HID * 2, gather_output=False)
        self.down = RowParallelLinear(HID * 2, HID, input_is_parallel=True)

    def forward(self, x):
        return self.down(nn.functional.relu(self.up(x)))


def _loss_fn(out, label):
    return ((out - label) ** 2).mean()


def _data(step):
    rs = np.random.RandomState(100 + step)
    return (paddle.to_tensor(rs.randn(BATCH, HID).astype("float32")),
            paddle.to_tensor(rs.randn(BATCH, HID).astype("float32")))


def _state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def _make_model(num_stages):
    return PipelineLayer([LayerDesc(_MLPBlock) for _ in range(N_BLOCKS)],
                         num_stages=num_stages, loss_fn=_loss_fn)


def _jax_reference(clip=None):
    jdist.set_mesh(None)
    paddle.seed(11)
    model = _make_model(1)
    state = _state(model)
    opt = paddle.optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(clip) if clip else None)
    losses = []
    for step in range(STEPS):
        x, y = _data(step)
        total = 0.0
        for mx, my in zip(paddle.split(x, MICRO, axis=0),
                          paddle.split(y, MICRO, axis=0)):
            loss = _loss_fn(model(mx), my)
            (loss / MICRO).backward()
            total += float(loss)
        opt.step()
        opt.clear_grad()
        losses.append(total / MICRO)
    return state, losses, _state(model)


def _jax_hybrid(pp, dp, mp, sharding, zero):
    s = DistributedStrategy()
    s.hybrid_configs.update(pp_degree=pp, dp_degree=dp, mp_degree=mp,
                            sharding_degree=sharding)
    s.pipeline_configs = {"accumulate_steps": MICRO,
                          "micro_batch_size": BATCH // MICRO}
    if zero:
        s.sharding = True
        s.sharding_configs = {"stage": zero}
    hcg = HybridCommunicateGroup(strategy=s)
    paddle.seed(11)
    model = _make_model(pp)
    wrapper = PipelineParallel(model, hcg=hcg, strategy=s)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    losses = [float(wrapper.train_batch(_data(step), opt))
              for step in range(STEPS)]
    jdist.set_mesh(None)
    return losses


@pytest.fixture(scope="module")
def runs():
    state, ref_losses, ref_params = _jax_reference()
    _, clip_losses, clip_params = _jax_reference(CLIP)
    jax_hybrid = {b: _jax_hybrid(*cfg) for b, cfg in CONFIGS.items()}
    inputs = {"hid": HID, "micro": MICRO, "batch": BATCH,
              "n_blocks": N_BLOCKS, "steps": STEPS, "hybrid_state": state,
              "clip": CLIP}
    bodies = list(CONFIGS) + ["body_hybrid_clip"]
    ranks = dist_ranks.run_ranks([f"dist_pipeline_bodies:{b}"
                                  for b in bodies], 8, inputs,
                                 deadline_s=240)
    got = {b: [r[f"dist_pipeline_bodies:{b}"] for r in ranks]
           for b in bodies}
    jax = {"ref": (ref_losses, ref_params), "clip": (clip_losses,
                                                     clip_params),
           "hybrid": jax_hybrid, "state": state}
    return jax, got


@pytest.mark.parametrize("body", list(CONFIGS))
def test_hybrid_loss_parity(runs, body):
    jax, got = runs
    for r in got[body]:
        np.testing.assert_allclose(r["losses"], jax["hybrid"][body],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["losses"], jax["ref"][0], rtol=1e-5,
                                   atol=1e-6)
    whole = gather_parts([r["params"] for r in got[body]])
    assert set(whole) == set(jax["ref"][1])
    for k, v in whole.items():
        np.testing.assert_allclose(v, jax["ref"][1][k], rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("body", list(CONFIGS))
def test_each_rank_holds_its_stage_with_tp_halves(runs, body):
    pp, dp, mp, sharding, zero = CONFIGS[body]
    _, got = runs
    state = runs[0]["state"]
    for r in got[body]:
        stage = r["coord"][0]
        blocks = {str(i) for i in (2 * stage, 2 * stage + 1)}
        assert {k.split(".")[1] for k in r["shapes"]} == blocks
        for k, shape in r["shapes"].items():
            full = list(state[k].shape)
            if k.endswith("up.weight"):
                full[1] //= mp
            elif k.endswith("up.bias"):
                full[0] //= mp
            elif k.endswith("down.weight"):
                full[0] //= mp
            if zero == 3 and full[0] % sharding == 0 and not (
                    mp > 1 and k.endswith("down.weight")):
                full[0] //= sharding
            assert list(shape) == full, (r["coord"], k, shape, full)


def test_zero2_gradients_are_rows_over_sharding(runs):
    _, got = runs
    for r in got["body_hybrid_pp_mp_zero2"]:
        assert r["zero_axis"] == "sharding"
        for k, shape in r["grad_shapes"].items():
            local = r["shapes"][k]
            if k.endswith(("down.weight", "up.bias")):
                # dim 0 already split over mp: whole, as JAX's pipeline
                # placement keeps it (pipeline.py:115-118)
                assert shape == local, k
            else:
                assert shape == (local[0] // 2,) + local[1:], k


def test_hybrid_global_norm_clip_is_the_whole_models(runs):
    """pp 2 x mp 2 x sharding 2 with ZeRO-2 and ClipGradByGlobalNorm: the
    norm summed over the three groups, each gradient once, clips as JAX's
    single process clips the whole model."""
    jax, got = runs
    losses, params = jax["clip"]
    assert not np.allclose(losses, jax["ref"][0], rtol=1e-4)   # it clips
    for r in got["body_hybrid_clip"]:
        assert r["clip"] == "HybridParallelClipGrad"
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5,
                                   atol=1e-6)
    whole = gather_parts([r["params"] for r in got["body_hybrid_clip"]])
    for k, v in whole.items():
        np.testing.assert_allclose(v, params[k], rtol=0, atol=1e-6,
                                   err_msg=k)
